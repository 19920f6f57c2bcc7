"""The dry run of the cells where the port did other work a device than
``repro``: zamba2's Mamba block, MLA's train step and the MoE layer,
each held to ``repro``'s record of the same cell.

One cell for each repair site, each ``lower_cell``'s at 2 layers with the
published config's ``embed`` rule and shapes cut as in
``test_torch_dryrun_heads.py`` (``dryrun_cells``):

- zamba2-1.2b train_4k on 16 x 16: the Mamba block's projections on each
  rank's rows of the split sequence, the SSD scan's heads split over the
  model axis;
- zamba2-1.2b decode_32k on 16 x 16: the SSM state's read-out on each
  rank's heads;
- minicpm3-4b train_4k on 2 x 16 x 16: MLA (40 heads, which do not divide
  16) on each rank's rows, scored against the gathered latents;
- granite-moe-3b-a800m train_4k on 16 x 16: the MoE dispatch over whole
  groups, the combine and the backward over each rank's rows;
- grok-1-314b decode_32k on 2 x 16 x 16: the expert weights gathered along
  ``embed`` (FSDP), the decode group computed whole, its combine by batch
  rows.

Each must capture, with FLOPs a device within 2 % of ``repro``'s
``lower_cell`` of the same cell (512 forced host devices, one subprocess
for the file); in the decode cells no collective takes a cache or state
as its input.
"""

import pytest

import dryrun_cells as D

CELLS = [("zamba2-1.2b", "train_4k", "16x16"),
         ("zamba2-1.2b", "decode_32k", "16x16"),
         ("minicpm3-4b", "train_4k", "2x16x16"),
         ("granite-moe-3b-a800m", "train_4k", "16x16"),
         ("grok-1-314b", "decode_32k", "2x16x16")]


@pytest.fixture(scope="module")
def repro():
    return D.repro_flops(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_repaired_cell_does_repros_work(cell, repro, monkeypatch):
    record, ops, _ = D.port_cell(monkeypatch, *cell)
    assert record["status"] == "ok"
    if cell[1].startswith("decode"):
        assert D.gathered_caches(ops) == []
    got, want = record["cost"]["flops_per_device"], repro[cell]
    ratio = got / want
    print(f"{'/'.join(cell)}: FLOPs a device port {got:.0f}, repro {want:.0f}, "
          f"ratio {ratio:.6f}")
    assert ratio == pytest.approx(1, abs=D.FLOPS_RTOL), (got, want)
