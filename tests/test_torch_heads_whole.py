"""Heads kept whole on a mesh whose model axis they do not divide, on 8 gloo
CPU ranks.

``sharded_ranks.HEADS_WHOLE``'s reduced archs on a (data 2, model 4) mesh
under ``repro``'s default plan with the published configs' FSDP rule
(``embed`` over ``data``).  deepseek-coder-33b with 6 query and 2 KV heads,
xlstm-1.3b with 2 mLSTM heads and minicpm3-4b's MLA with 6 heads keep their
heads off ``model``: the sequence over it in the train step and the prefill
(each ``model`` rank's query rows start at 0, 8, 16 or 24 of 32), and in
decode the caches' sequence over it (caches of 48 positions, 12 a rank:
the step at position 32 writes into rank 2's slice, and rank 3's lies
wholly past the filled keys).  gemma-2b with 8 query and 2 KV heads splits
its query heads over ``model`` and keeps the KV heads whole (each rank's
query heads over all the KV heads; in decode, the caches split as above).
xlstm-1.3b with 4 heads, which divide ``model``, runs its products as the
plan places them.  The ranks are spawned once for the file
(``sharded_ranks.seq_parallel_steps``), in f32 and in f64, and held, as
``test_torch_seq_parallel.py`` holds its archs (``seq_parallel_parity``),
against ``repro``'s sharded step, prefill and decode under the same plan
on 8 forced host devices (f64 within 1e-9 relative, each parameter's
gradient norm among them; f32 by ``train_parity``'s rule) and against the
port's one-device computations.
"""

import pytest

import seq_parallel_parity as SP
import sharded_ranks

ARCHS = list(sharded_ranks.HEADS_WHOLE)
RULES = sharded_ranks.HEADS_WHOLE_RULES
#: the caches' length: 12 positions a model rank, so the last rank's slice
#: starts past the decode step's 33 filled keys
S_MAX = 48


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return SP.make_inputs(tmp_path_factory.mktemp("heads_whole"), sharded_ranks.HEADS_WHOLE)


@pytest.fixture(scope="module")
def sharded(inputs):
    return SP.run_sharded(inputs, RULES, S_MAX)


@pytest.fixture(scope="module")
def reference(inputs):
    return SP.run_reference(inputs, RULES, S_MAX)


#: the archs whose query heads are kept whole on the (2, 4) mesh
#: (``context.attention_placement``); gemma-2b keeps its KV heads alone whole
ROWS = {"deepseek-coder-33b", "xlstm-1.3b", "minicpm3-4b"}


def test_the_plan_keeps_the_heads_whole():
    from types import SimpleNamespace

    from repro_torch.parallel.context import attention_placement, parallel_context
    from repro_torch.parallel.sharding import default_plan

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), size=(2, 4).__getitem__)
    for arch in ARCHS:
        cfg = sharded_ranks.seq_parallel_config(arch, sharded_ranks.HEADS_WHOLE)
        plan = default_plan(cfg, {"data": 2, "model": 4}).override(**RULES)
        assert (plan.get("heads") is None) == bool(cfg.n_heads % 4), arch
        assert plan.get("seq") == "model", arch
        with parallel_context(mesh, plan):
            placement = attention_placement(cfg.n_heads)
        assert (placement.heads == "rows") == (arch in ROWS), arch
        if arch == "gemma-2b":
            assert placement.heads == "kv_rows"
        assert placement.cache_slices == (plan.get("kv_seq") == "model"), arch
    assert 3 * S_MAX // 4 > 32


@pytest.mark.parametrize("arch", ARCHS)
def test_heads_whole_step_and_split_cache_decode_match_one_device(inputs, sharded, arch):
    got = sharded[arch, "float32"]
    want = SP.one_device(inputs, arch, s_max=S_MAX)
    exact = SP.one_device(inputs, arch, exact=True, s_max=S_MAX)
    SP.check_scalars(got, want, exact)
    SP.check_logits(got, want, exact)


@pytest.mark.parametrize("arch", ARCHS)
def test_heads_whole_train_step_matches_repro(sharded, reference, arch):
    SP.check_scalars(sharded[arch, "float32"], reference[arch, "float32"],
                     reference[arch, "float64"])
    SP.check_exact(sharded[arch, "float64"], reference[arch, "float64"])


@pytest.mark.parametrize("arch", ARCHS)
def test_heads_whole_prefill_and_split_cache_decode_match_repro(sharded, reference, arch):
    SP.check_logits(sharded[arch, "float32"], reference[arch, "float32"],
                    reference[arch, "float64"])
