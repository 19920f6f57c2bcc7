"""The dry run's communication and decode work held to ``repro``'s.

Two placements of the sharded model layer, each held to ``repro``'s record
of the same cell (``dryrun_cells``: 2 layers, cut shapes, the published
config's ``embed`` rule; ``repro``'s ``lower_cell`` on 512 forced host
devices, one subprocess for the file):

- the embedding looked up in each rank's own vocab rows
  (``context.embedding``), where the table was gathered whole every step:
  gemma-2b decode_32k on 16 x 16 (the tied table, 15/16 of it moved
  before), olmo-1b prefill_32k on 2 x 16 x 16 (the sequence split over
  ``model``) and deepseek-coder-33b decode_32k on 16 x 16 (the table's
  ``embed`` over ``data``: the tokens gathered, the columns turned into
  rows by an all-to-all).  The ``embed`` region's wire bytes a device are
  at most ``EMBED_WIRE_RATIO`` times ``repro``'s;
- decode's q/k/v projections with the heads kept whole, contracted over
  each ``model`` rank's slice of ``d_model`` where GSPMD cuts them
  (``context.contraction_slices``: FSDP over 16 ranks against a model axis
  of 16) and by the gathered weights where it gathers them (32 against
  16): deepseek-coder-33b and qwen2-vl-7b decode_32k on both meshes, FLOPs
  a device within ``FLOPS_RTOL`` of ``repro``'s.
"""

import pytest

import dryrun_cells as D

EMBED_CELLS = [("gemma-2b", "decode_32k", "16x16"),
               ("olmo-1b", "prefill_32k", "2x16x16"),
               ("deepseek-coder-33b", "decode_32k", "16x16")]
DECODE_CELLS = [(a, "decode_32k", m) for a in ("deepseek-coder-33b", "qwen2-vl-7b")
                for m in ("16x16", "2x16x16")]


@pytest.fixture(scope="module")
def repro():
    return D.repro_records(dict.fromkeys(EMBED_CELLS + DECODE_CELLS))


@pytest.fixture(scope="module")
def port():
    """Each cell's record, captured once for the file."""
    records = {}

    def get(cell):
        if cell not in records:
            with pytest.MonkeyPatch.context() as mp:
                records[cell] = D.port_cell(mp, *cell)[0]
        return records[cell]

    return get


@pytest.mark.parametrize("cell", EMBED_CELLS, ids=["/".join(c) for c in EMBED_CELLS])
def test_embedding_moves_at_most_twice_repros_bytes(cell, repro, port):
    record = port(cell)
    assert record["status"] == "ok"
    got = D.region_wire(record["collectives"], "embed")
    want = D.region_wire(repro[cell]["collectives"], "embed")
    print(f"{'/'.join(cell)}: embed wire bytes a device port {got:.0f}, repro {want:.0f}")
    assert 0 < want and got <= D.EMBED_WIRE_RATIO * want, (got, want)


@pytest.mark.parametrize("cell", DECODE_CELLS, ids=["/".join(c) for c in DECODE_CELLS])
def test_decode_projections_do_repros_work(cell, repro, port):
    record = port(cell)
    assert record["status"] == "ok"
    got, want = record["cost"]["flops_per_device"], repro[cell]["flops"]
    print(f"{'/'.join(cell)}: FLOPs a device port {got:.0f}, repro {want:.0f}, "
          f"ratio {got / want:.6f}")
    assert got / want == pytest.approx(1, abs=D.FLOPS_RTOL), (got, want)
