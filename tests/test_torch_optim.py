"""The port's optimizer, data pipeline, gradient compression and launcher.

* ``apply_updates`` against ``repro``'s on the same parameters and
  gradients (f32 and bf16 leaves, two steps): rtol 1e-6, and the bf16
  leaves bit-equal (the same f32 update rounds to the same bf16);
* the AdamW tests of ``tests/test_substrate.py``;
* the data tests of ``tests/test_substrate.py``, and the unigram and drift
  statistics against ``repro``'s stream (the bits differ by design: numpy
  against ``jax.random``): 20 batches of 8 x 256 tokens over a 64-token
  vocab, each of the 8 commonest tokens' frequency and the drift fraction
  within 0.02 (about 8 standard errors of the difference of two such
  samples);
* ``compressed_psum`` on 8 gloo ranks (``run_ranks``): the mean within 0.05
  of the exact one and the residual under 0.05, as ``repro``'s test holds
  it, and within 1e-6 of ``repro``'s own result on 8 host devices (the
  residual, which cancels to a few ulps of the gradient, within 1e-6
  absolute); its
  traced ``CommProfile.to_json()`` byte-equal to ``repro``'s
  ``profile_traced`` of the same function;
* the launcher on the CPU: a resume from a checkpoint (periodic, and the
  one SIGTERM forces) equal bit for bit to the uninterrupted run, the
  straggler monitor, and the refusals.
"""

import json
import os
import shutil
import signal
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import compress_ranks
from helpers import run_with_devices
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.optim import adamw as jax_adamw
from repro_torch.core import compat
from repro_torch.core.backend import BackendUnavailable
from repro_torch.core.profiler import profile_traced
from repro_torch.core.ranks import run_ranks
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as launch
from repro_torch.optim import adamw, compress

# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _leaves(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((8, 4)).astype(np.float32),
        "hb": rng.standard_normal((4, 4)).astype(np.float32),
        "b": rng.standard_normal((4,)).astype(np.float32),
    }


def _bf16(x):
    """The same bf16 values as a torch tensor and a JAX array."""
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def test_apply_updates_matches_repro():
    cfg = dict(lr=0.05, warmup_steps=1, total_steps=10)
    p = _leaves(0)
    # copies: the port updates in place, and jnp.asarray may share memory
    tp = {"w": torch.tensor(p["w"]), "b": torch.tensor(p["b"])}
    jp = {"w": jnp.asarray(p["w"]), "b": jnp.asarray(p["b"])}
    tp["hb"], jp["hb"] = _bf16(p["hb"])
    tstate, jstate = adamw.init_state(tp), jax_adamw.init_state(jp)
    for step in (1, 2):
        g = {k: v * 30 for k, v in _leaves(step).items()}  # clipped: norm > 1
        tg = {"w": torch.from_numpy(g["w"]), "b": torch.from_numpy(g["b"])}
        jg = {"w": jnp.asarray(g["w"]), "b": jnp.asarray(g["b"])}
        tg["hb"], jg["hb"] = _bf16(g["hb"])
        tstate, tm = adamw.apply_updates(adamw.OptConfig(**cfg), tp, tg, tstate)
        jp, jstate, jm = jax_adamw.apply_updates(jax_adamw.OptConfig(**cfg), jp, jg,
                                                 jstate)
        assert int(tstate["step"]) == int(jstate["step"]) == step
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
        for name in ("w", "hb", "b"):
            assert tp[name].dtype == (torch.bfloat16 if name == "hb" else torch.float32)
            want = np.asarray(jp[name], np.float32)
            np.testing.assert_allclose(tp[name].float().numpy(), want, rtol=1e-6)
            if name == "hb":
                np.testing.assert_array_equal(tp[name].float().numpy(), want)
            for part in ("m", "v"):
                assert tstate[part][name].dtype == torch.float32
                np.testing.assert_allclose(tstate[part][name].numpy(),
                                           np.asarray(jstate[part][name]), rtol=1e-6)


def test_adamw_optimizes_quadratic():
    cfg = adamw.OptConfig(lr=0.2, warmup_steps=1, total_steps=400,
                          weight_decay=0.0, clip_norm=100.0, min_lr_frac=0.5)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_state(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w**2), [w])
        state, _ = adamw.apply_updates(cfg, params, {"w": g}, state)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


def test_schedule_shape():
    cfg = adamw.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(0, 101, 5)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0, rel=1e-3)
    assert lrs[-1] == pytest.approx(0.1, rel=1e-2)


def test_grad_clipping():
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, 1e-3)


def test_step_scalars_stay_on_the_parameters_device():
    params = {"w": torch.ones(3)}
    state, metrics = adamw.apply_updates(adamw.OptConfig(), params,
                                         {"w": torch.ones(3)}, adamw.init_state(params))
    for t in (state["step"], metrics["lr"], metrics["grad_norm"]):
        assert isinstance(t, torch.Tensor) and t.device == params["w"].device
    assert state["step"].dtype == torch.int32
    assert metrics["lr"].dtype == metrics["grad_norm"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 17, 999])
def test_data_pure_in_step(step):
    ds = SyntheticLM(DataConfig(vocab=128, seq_len=32, global_batch=4))
    a, b = ds.batch(step), ds.batch(step)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"], a["labels"])
    assert a["tokens"].dtype == torch.int64 and a["tokens"].device.type == "cpu"
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 128


def test_data_steps_differ_and_shard_disjoint():
    ds = SyntheticLM(DataConfig(vocab=128, seq_len=32, global_batch=4))
    assert not torch.equal(ds.batch(0)["tokens"], ds.batch(1)["tokens"])
    p0 = ds.batch(0, process_index=0, process_count=2)
    p1 = ds.batch(0, process_index=1, process_count=2)
    assert p0["tokens"].shape == (2, 32)
    assert not torch.equal(p0["tokens"], p1["tokens"])
    with pytest.raises(ValueError, match="does not split"):
        ds.batch(0, process_count=3)


def test_data_has_learnable_structure():
    """The Markov drift must make next-token prediction beatable."""
    ds = SyntheticLM(DataConfig(vocab=64, seq_len=256, global_batch=8))
    t = ds.batch(0)["tokens"].numpy()
    frac = (t[:, 1:] == (t[:, :-1] + 1) % 64).mean()
    assert frac > 0.2, frac


def _stats(tokens: np.ndarray, vocab: int) -> tuple:
    freq = np.bincount(tokens.ravel(), minlength=vocab) / tokens.size
    drift = (tokens[:, 1:] == (tokens[:, :-1] + 1) % vocab).mean()
    return freq, drift


def test_unigram_and_drift_match_repros_stream():
    vocab, n = 64, 20
    port = SyntheticLM(DataConfig(vocab=vocab, seq_len=256, global_batch=8, seed=3))
    ref = JaxSyntheticLM(JaxDataConfig(vocab=vocab, seq_len=256, global_batch=8,
                                       seed=3))
    np.testing.assert_array_equal(port.probs, np.asarray(ref.probs))
    got = np.concatenate([port.batch(s)["tokens"].numpy() for s in range(n)])
    want = np.concatenate([np.asarray(ref.batch(s)["tokens"]) for s in range(n)])
    (f_got, d_got), (f_want, d_want) = _stats(got, vocab), _stats(want, vocab)
    top = np.argsort(-f_want)[:8]
    np.testing.assert_allclose(f_got[top], f_want[top], atol=0.02)
    assert abs(d_got - d_want) < 0.02, (d_got, d_want)


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------

_JAX_COMPRESS = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import compat
from repro.core.profiler import profile_traced
from repro.optim.compress import compressed_psum, init_error_state
mesh = compat.make_mesh((8,), ("data",))

def run(grads, err):
    def inner(g, e):
        return compressed_psum(g, e, "data")
    return compat.shard_map(inner, mesh=mesh, in_specs=(P("data"), P("data")),
                            out_specs=(P("data"), P("data")))(grads, err)

g = jnp.asarray(np.load({grads!r}))
grads = {{"w": g}}
# the trace first: JAX caches the traced body, which a later trace skips
prof = profile_traced(run, grads, init_error_state(grads), name="compressed_psum")
open({profile!r}, "w").write(prof.to_json())
mean, err = jax.jit(run)(grads, init_error_state(grads))
np.savez({out!r}, mean=np.asarray(mean["w"]), err=np.asarray(err["w"]))
print("OK")
"""


def _port_run(grads, err):
    mesh = compat.make_mesh((8,), ("data",))
    spec = {"w": compat.PartitionSpec("data")}
    return compat.shard_map(lambda g, e: compress.compressed_psum(g, e, "data"),
                            mesh=mesh, in_specs=(spec, spec),
                            out_specs=(spec, spec))(grads, err)


def test_compressed_psum_on_8_ranks_matches_repro():
    g = (np.arange(8 * 64, dtype=np.float32) / 100.0).reshape(8 * 64)
    port = run_ranks(compress_ranks.run_sharded, 8, backend="gloo", args=({"w": g},))
    exact = g.reshape(8, 64).mean(axis=0)
    got = port["mean"]["w"].reshape(8, 64)
    for r in range(8):
        np.testing.assert_allclose(got[r], exact, atol=0.05)
    assert float(np.abs(port["err"]["w"]).max()) < 0.05
    grads = {"w": torch.empty(8 * 64, device="meta")}
    prof = profile_traced(_port_run, grads, compress.init_error_state(grads),
                          name="compressed_psum", backend="numpy")
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"{k}.{ext}") for k, ext in
                 (("grads", "npy"), ("out", "npz"), ("profile", "json"))}
        np.save(paths["grads"], g)
        run_with_devices(_JAX_COMPRESS.format(**paths))
        with np.load(paths["out"]) as data:
            np.testing.assert_allclose(port["mean"]["w"], data["mean"], rtol=1e-6,
                                       atol=1e-7)
            # the residual gf - q * scale cancels to a few ulps of gf (~2.4e-7
            # at 2.2), and XLA may fuse it into one FMA
            np.testing.assert_allclose(port["err"]["w"], data["err"], rtol=1e-6,
                                       atol=1e-6)
        with open(paths["profile"]) as f:
            want = f.read()
    assert prof.to_json() == want
    regions = json.loads(want)["regions"]
    assert list(regions) == ["grad_allreduce"]
    assert regions["grad_allreduce"]["kinds"] == {"pmax": 1, "psum": 1}


def test_replicated_compressed_allreduce_traces_one_pair_a_leaf():
    mesh = compat.make_mesh((8,), ("data",))
    fn = compress.make_compressed_allreduce(mesh)
    grads = {"a": torch.empty(16, device="meta"), "b": torch.empty(4, 4, device="meta")}
    prof = profile_traced(fn, grads, compress.init_error_state(grads), backend="numpy")
    stats = json.loads(prof.to_json())["regions"]["grad_allreduce"]
    assert stats["kinds"] == {"pmax": 2, "psum": 2}


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------


def _run(ckpt_dir, **kw) -> launch.RunConfig:
    base = dict(arch="olmo-1b", steps=6, seq_len=16, global_batch=2, ckpt_every=3,
                warmup_steps=2, ckpt_dir=str(ckpt_dir), device="cpu")
    return launch.RunConfig(**{**base, **kw})


def test_resume_from_a_checkpoint_is_bit_exact(tmp_path):
    losses, _ = launch.train(_run(tmp_path / "a"), verbose=False)
    assert len(losses) == 6 and all(np.isfinite(losses))
    # drop the last checkpoint: the next run resumes from step 3
    shutil.rmtree(tmp_path / "a" / "step_00000006")
    resumed, _ = launch.train(_run(tmp_path / "a"), verbose=False)
    assert resumed == losses[3:]


def test_sigterm_saves_and_the_resume_is_bit_exact(tmp_path, monkeypatch):
    whole, _ = launch.train(_run(tmp_path / "whole"), verbose=False)
    batch = SyntheticLM.batch

    def preempting(self, step, **kw):
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return batch(self, step, **kw)

    monkeypatch.setattr(SyntheticLM, "batch", preempting)
    first, _ = launch.train(_run(tmp_path / "b"), verbose=False)
    monkeypatch.setattr(SyntheticLM, "batch", batch)
    assert first == whole[:2]
    assert sorted(os.listdir(tmp_path / "b")) == ["step_00000002"]
    rest, _ = launch.train(_run(tmp_path / "b"), verbose=False)
    assert first + rest == whole
    assert signal.getsignal(signal.SIGTERM) is not None


def test_straggler_monitor_flags_slow_steps():
    mon = launch.StragglerMonitor(3.0)
    times = [1.0, 1.1, 0.9, 5.0, 1.0, 1.0]
    flags = [mon.observe(i, t) for i, t in enumerate(times)]
    assert flags == [False, False, False, True, False, False]
    assert mon.flagged == [(3, 5.0)]
    assert mon.ewma == pytest.approx(
        0.9 * (0.9 * (0.9 * (0.9 * (0.9 * 1.0 + 0.1 * 1.1) + 0.1 * 0.9) + 0.1 * 5.0)
               + 0.1 * 1.0) + 0.1 * 1.0)


def test_launcher_refuses_a_mesh_and_a_missing_card(tmp_path):
    with pytest.raises(ValueError, match="one device"):
        launch.train(_run(tmp_path, data_mesh=(2, 1)), verbose=False)
    if not torch.cuda.is_available():
        with pytest.raises(BackendUnavailable):
            launch.train(_run(tmp_path, device="cuda"), verbose=False)
    assert launch.RunConfig().device == "cuda"


def test_main_trains_on_the_cpu_and_the_example_is_about_100m(tmp_path):
    from repro_torch.configs import registry
    from repro_torch.examples import train_lm

    losses, mon = launch.main(["--arch", "gemma-2b", "--steps", "2", "--seq-len", "16",
                               "--global-batch", "2", "--device", "cpu",
                               "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and [s for s, _ in mon.times] == [0, 1]
    cfg = registry.get(train_lm.register_100m())
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (8, 768, 50304)
    assert 90e6 < cfg.param_count() < 130e6
