"""The dry run of the archs whose attention heads do not divide the model
axis, held to ``repro``'s record of the same cell.

``repro``'s default plan keeps such heads off ``model`` and splits the
sequence over it (train, prefill), or the decode cache's sequence
(``kv_seq``).  Each cell is ``lower_cell``'s at 2 layers, with the
published config's ``embed`` rule (FSDP, which the cut depth would drop)
and shapes cut to train 32 x 1024, prefill 32 x 1024 and decode 128 x 4096
(``dryrun_cells.CUT``): one cell for each site where DTensor could not
place them, deepseek-coder-33b (56 heads, 8 KV heads) in train and decode,
grok-1-314b (48 heads, 8 KV) in prefill, qwen2-vl-7b (28 heads, 4 KV) in
train and minicpm3-4b's MLA (40 heads) in decode.  Each must capture, with
FLOPs a device within 2 % of ``repro``'s ``lower_cell`` of the same cell
(512 forced host devices, one subprocess for the file).  In the decode
cells no collective takes a cache as its input, and none of the attention
region's moves as many bytes as one layer's cache on a device, but the
gathers of the weights (FSDP), known by their inputs, the parameters: the
cache is attended slice by slice, never gathered.

xlstm-1.3b's cells are in ``test_torch_dryrun_xlstm.py``.
"""

import pytest

import dryrun_cells as D

CELLS = [("deepseek-coder-33b", "train_4k", "16x16"),
         ("deepseek-coder-33b", "decode_32k", "2x16x16"),
         ("grok-1-314b", "prefill_32k", "2x16x16"),
         ("qwen2-vl-7b", "train_4k", "2x16x16"),
         ("minicpm3-4b", "decode_32k", "16x16")]


@pytest.fixture(scope="module")
def repro():
    return D.repro_flops(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_cell_places_with_repros_flops(cell, repro, monkeypatch):
    record, ops, cache_bytes = D.port_cell(monkeypatch, *cell)
    assert record["status"] == "ok"
    if cell[1].startswith("decode"):
        # the cache stays split: no collective takes a cache as its input,
        # and none of the attention region's but a weight's (FSDP) gathers
        # moves as many bytes as one layer's cache on a device
        assert D.gathered_caches(ops) == []
        worst = D.largest_activation_collective(ops)
        assert 0 < worst < cache_bytes, (worst, cache_bytes)
    got, want = record["cost"]["flops_per_device"], repro[cell]
    ratio = got / want
    print(f"{'/'.join(cell)}: FLOPs a device port {got:.0f}, repro {want:.0f}, "
          f"ratio {ratio:.6f}")
    assert ratio == pytest.approx(1, abs=D.FLOPS_RTOL), (got, want)
