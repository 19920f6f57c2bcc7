"""The dry run of xlstm-1.3b, whose 4 mLSTM heads do not divide the model
axis, held to ``repro``'s record of the same cell.

Each cell is ``lower_cell``'s at 2 layers with shapes cut as in
``test_torch_dryrun_heads.py`` (``dryrun_cells``): train_4k on 16 x 16,
prefill_32k on 2 x 16 x 16, decode_32k on 16 x 16 and long_500k on
2 x 16 x 16.  Each must capture.  At 1024 rows over 16 model ranks the
mLSTM scan splits each chunk's rows over the ranks that hold them and
runs every chunk on every rank, as GSPMD does (``ops._mlstm_rows``); the
decode state splits its value dim over the model axis
(``xlstm.mlstm_decode``).  The port's chunked
mLSTM prunes products ``repro``'s scan runs (``test_torch_hlo_cost.py``),
so a cell's FLOPs a device are held to within 2 % of repro's times the
two's ratio on one device, at the same config and shape (``repro``
compiled on one host device, the port captured without a mesh).
``repro`` records 0 FLOPs for long_500k: there the state's read-out is
held to its value slice.  In the decode cells no collective takes an
mLSTM state as its input, and none of the mLSTM region's moves as many
bytes as one layer's mLSTM state on a device, but the gathers of the
weights (FSDP), known by their inputs, the parameters.
"""

import json
from dataclasses import replace

import pytest
from helpers import run_with_devices

import dryrun_cells as D
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun

CELLS = [("xlstm-1.3b", "train_4k", "16x16"),
         ("xlstm-1.3b", "prefill_32k", "2x16x16"),
         ("xlstm-1.3b", "decode_32k", "16x16"),
         ("xlstm-1.3b", "long_500k", "2x16x16")]

_REPRO_ONE = """
import json
from dataclasses import replace
import jax, jax.numpy as jnp
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.core.hlo_cost import analyze_cost
from repro.optim import adamw
from repro.train import steps as S
cfg = replace(registry.get("xlstm-1.3b"), n_layers={layers})
out = {{}}
for name, (kind, seq, batch) in {cut!r}.items():
    shape = ShapeConfig(name, kind, seq, batch)
    if kind == "train":
        step, model = S.make_train_step(cfg)
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        args = (params, jax.eval_shape(adamw.init_state, params), S.batch_specs(cfg, shape))
    elif kind == "prefill":
        step, model = S.make_prefill_step(cfg, s_max=seq)
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        batch = S.batch_specs(cfg, shape)
        batch.pop("labels", None)
        args = (params, batch)
    else:
        step, model = S.make_decode_step(cfg)
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        args = (params, S.cache_specs(cfg, shape), S.decode_token_specs(cfg, shape),
                jnp.int32(seq - 1))
    out[name] = analyze_cost(jax.jit(step).lower(*args).compile().as_text()).flops
print("ONE", json.dumps(out))
"""

_SHAPES = sorted({shape for _, shape, _ in CELLS})


@pytest.fixture(scope="module")
def repro():
    """repro's FLOPs a device of each cell, and of each shape on one device."""
    cut = {name: D.CUT[name] for name in _SHAPES}
    one = run_with_devices(_REPRO_ONE.format(layers=D.N_LAYERS, cut=cut), n_devices=1)
    return D.repro_flops(CELLS), json.loads(one.split("ONE", 1)[1])


def _port_one(shape: str) -> float:
    kind, seq, batch = D.CUT[shape]
    cfg = replace(registry.get("xlstm-1.3b"), n_layers=D.N_LAYERS)
    record, _ = dryrun.lower(cfg, ShapeConfig(shape, kind, seq, batch))
    return record["cost"]["flops_per_device"]


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_xlstm_cell_places_with_repros_flops(cell, repro, monkeypatch):
    graphs = []
    record, ops, state_bytes = D.port_cell(monkeypatch, *cell, graphs=graphs)
    assert record["status"] == "ok"
    if D.CUT[cell[1]][0] == "decode":
        assert D.gathered_caches(ops) == []
        worst = D.largest_activation_collective(ops)
        assert 0 < worst < state_bytes, (worst, state_bytes)
    mesh, one = repro
    got, want = record["cost"]["flops_per_device"], mesh[cell]
    port_one, repro_one = _port_one(cell[1]), one[cell[1]]
    expected = port_one / repro_one
    ratio = got / want if want else float("inf")
    print(f"{'/'.join(cell)}: FLOPs a device port {got:.0f}, repro {want:.0f}, "
          f"ratio {ratio:.6f}; one device port {port_one:.0f}, repro "
          f"{repro_one:.0f}, ratio {expected:.6f}")
    if not want:
        # the decode state's read-out q C (B H, 1, Dk) x (B H, Dk, Dv) on the
        # rank's value columns: Dv / 16
        reads = [shapes for _, _, op, shapes in D.by_op(graphs[-1], top=100)
                 if op == "bmm" and shapes[0][1] == 1 and shapes[0][2] == shapes[1][1] == 1024]
        assert reads and all(s[1][2] == 1024 // 16 for s in reads), reads
        return
    assert ratio / expected == pytest.approx(1, abs=D.FLOPS_RTOL), (got, want, expected)
