"""The port's cost accounting against ``repro``'s.

``analyze_cost`` and ``analyze_cost_reference`` over HLO text are held bit
for bit to ``repro.core.hlo_cost`` on the golden corpus.  ``graph_cost``
over a captured one-device train step is held to ``repro``'s
``analyze_cost`` of its compiled step (JAX in a subprocess): the product
FLOPs are the same products, exactly, for the reduced olmo-1b,
granite-moe-3b-a800m and minicpm3-4b; zamba2-1.2b and xlstm-1.3b differ by
the gaps explained in :func:`test_graph_cost_matches_repro_at_one_device`.
"""

import glob
import json
import os

import pytest
import torch
from helpers import run_with_devices

from repro.core import hlo_cost as ref_cost
from repro_torch.core import hlo_cost

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "fixtures",
                                         "hlo", "*.txt")))

NO_ENTRY = (
    "%plain (p: f32[8]) -> f32[8] {\n"
    "  %p = f32[8]{0} parameter(0)\n"
    "  ROOT %d = f32[8]{0} dot(%p, %p), lhs_contracting_dims={0}\n"
    "}\n"
)

#: the one-device train step both sides count: batch 8 x 32 tokens
BATCH, SEQ = 8, 32

#: repro's product FLOPs minus the port's, each family's reduced step
GAPS = {
    "olmo-1b": 0,
    "granite-moe-3b-a800m": 0,
    "minicpm3-4b": 0,
    "zamba2-1.2b": 1_310_720,
    "xlstm-1.3b": 68_419_584,
}

_REPRO_COST = """
    import json, jax
    from repro.configs import registry
    from repro.configs.base import ShapeConfig
    from repro.core.hlo_cost import analyze_cost
    from repro.optim import adamw
    from repro.train import steps as S
    out = {}
    for arch in %r:
        cfg = registry.get(arch).reduced()
        step, model = S.make_train_step(cfg)
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        opt = jax.eval_shape(adamw.init_state, params)
        batch = S.batch_specs(cfg, ShapeConfig("t", "train", %d, %d))
        text = jax.jit(step).lower(params, opt, batch).compile().as_text()
        out[arch] = analyze_cost(text).flops
    print("COST", json.dumps(out))
""" % (tuple(GAPS), SEQ, BATCH)


def _fields(c) -> tuple:
    return (c.flops, c.bytes_accessed, c.dot_flops_unscaled)


@pytest.mark.parametrize(
    "path", FIXTURES, ids=[os.path.basename(p)[: -len(".txt")] for p in FIXTURES]
)
def test_analyze_cost_bit_equal_to_repro(path):
    with open(path) as f:
        text = f.read()
    want = _fields(ref_cost.analyze_cost(text))
    assert _fields(hlo_cost.analyze_cost(text)) == want
    assert _fields(hlo_cost.analyze_cost_reference(text)) == want
    assert _fields(ref_cost.analyze_cost_reference(text)) == want


def test_analyze_cost_without_entry_marker_bit_equal_to_repro():
    want = _fields(ref_cost.analyze_cost(NO_ENTRY))
    assert want[0] > 0 and want[1] > 0
    assert _fields(hlo_cost.analyze_cost(NO_ENTRY)) == want
    assert _fields(hlo_cost.analyze_cost_reference(NO_ENTRY)) == want


def _train_graph(cfg):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import capture

    gm, _, _ = capture(cfg, ShapeConfig("t", "train", SEQ, BATCH))
    return gm


@pytest.fixture(scope="module")
def repro_costs() -> dict:
    out = run_with_devices(_REPRO_COST, n_devices=1)
    return json.loads(out.split("COST", 1)[1])


@pytest.mark.parametrize("arch", list(GAPS))
def test_graph_cost_matches_repro_at_one_device(arch, repro_costs):
    """graph_cost of the port's captured step against repro's analyze_cost
    of its compiled step, same reduced config and batch.

    The products are the same, except where the two graphs differ:

    - zamba2-1.2b, 1,310,720 FLOPs short: 15 small contractions, 3 a
      Mamba-2 layer, in the SSD's backward.  ``repro``'s chunked SSD
      (``repro/models/mamba.py:82``) writes the chunk states and the
      chunk outputs as three-operand einsums (``bcjn,bcjh,bcjhp->bchpn``,
      ``bcqn,bchpn,bcqh->bcqhp``) and XLA lowers their transposes with the
      per-row decay factors as ``dot``s (results of 2048 and 4096 elements
      over 8, 16 or 32 terms); the port's plain SSD takes those gradients
      as a product and a sum, no matrix product.
    - xlstm-1.3b, 68,419,584 FLOPs short: ``repro``'s chunkwise mLSTM
      (``repro/models/xlstm.py:98``) is a ``lax.scan`` whose body, and its
      transpose, run the same products for every chunk: the last chunk's
      state update (the final state, which the loss does not read) and
      the gradients into the first chunk's entering state (zeros) and out
      of the last chunk's leaving state.  In the port's loop over chunks
      the capture drops the dead update and autograd never takes those
      gradients.  ``repro`` also contracts ñ's update as a ``dot`` where
      the port sums rows, and the port's gradient of q·ñ is an outer
      product (k = 1) that ``repro`` does not need.
    """
    from repro_torch.configs import registry

    got = hlo_cost.graph_cost(_train_graph(registry.get(arch).reduced()))
    assert got.flops > 0 and got.flops == got.dot_flops_unscaled
    assert repro_costs[arch] - got.flops == GAPS[arch], (arch, got.flops,
                                                         repro_costs[arch])


def test_remat_full_counts_the_recomputed_forward():
    """Under remat "full" the backward recomputes each layer's forward, so
    its products count twice: the difference from "none" is the forward's
    products without the LM head's, less each layer's last product (the
    FFN's down projection), whose result the backward does not read and
    the checkpoint's recompute stops before."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.configs import registry
    from repro_torch.models.model import build_model

    cfg = registry.get("olmo-1b").reduced()
    none = hlo_cost.graph_cost(_train_graph(cfg)).flops
    full = hlo_cost.graph_cost(_train_graph(
        registry.get("olmo-1b").reduced(remat="full"))).flops
    model = build_model(cfg, device="cpu")
    tokens = torch.zeros(BATCH, SEQ, dtype=torch.int32)
    with torch.no_grad():
        fwd = hlo_cost.graph_cost(make_fx(
            lambda t: model.train_logits({"tokens": t})[0])(tokens)).flops
    head = 2.0 * BATCH * SEQ * cfg.d_model * cfg.vocab_padded
    down = 2.0 * BATCH * SEQ * cfg.d_ff * cfg.d_model * cfg.n_layers
    assert full - none == fwd - head - down > 0


def test_view_only_graph_counts_nothing():
    from torch.fx.experimental.proxy_tensor import make_fx

    def views(x):
        y = x.t()[1:].unsqueeze(0).expand(2, 3, 6)
        return y.detach(), x.view(-1)[::2]

    cost = hlo_cost.graph_cost(make_fx(views)(torch.zeros(6, 4)))
    assert (cost.flops, cost.bytes_accessed) == (0.0, 0.0)


@pytest.mark.parametrize("op", ["mm", "addmm", "bmm", "baddbmm", "einsum"])
def test_products_count_flops_and_bytes(op):
    """2 M N K FLOPs a product; operand and result bytes of the kernel."""
    from torch.fx.experimental.proxy_tensor import make_fx

    a, b = torch.zeros(2, 3, 5), torch.zeros(2, 5, 7)
    c = torch.zeros(2, 3, 7)
    fns = {
        "mm": lambda a, b, c: a[0] @ b[0],
        "addmm": lambda a, b, c: torch.addmm(c[0], a[0], b[0]),
        "bmm": lambda a, b, c: torch.bmm(a, b),
        "baddbmm": lambda a, b, c: torch.baddbmm(c, a, b),
        "einsum": lambda a, b, c: torch.einsum("gik,gkj->gij", a, b),
    }
    gm = make_fx(fns[op])(a, b, c)
    cost = hlo_cost.graph_cost(gm)
    g = 1 if op in ("mm", "addmm") else 2
    assert cost.flops == 2.0 * g * 3 * 5 * 7
    kernels = [n for n in gm.graph.nodes if hlo_cost.node_bytes(n)]
    assert [n.target.overloadpacket.__name__ for n in kernels] == [
        {"einsum": "bmm"}.get(op, op)]
    extra = g * 3 * 7 * 4 if op in ("addmm", "baddbmm") else 0
    assert cost.bytes_accessed == 4 * g * (3 * 5 + 5 * 7 + 3 * 7) + extra
