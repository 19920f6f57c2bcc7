"""The port's kripke against the JAX package's.

Profiles are traced by each package (meta tensors here, ``jax.eval_shape``
there) and must serialize byte for byte alike.  The configurations are the
paper findings of ``tests/test_apps.py`` (corner/interior partners, 36
messages per phase, the fusion knob, weak scaling), the backend-parity
configuration of ``tests/test_backend_parity.py`` and one fused weak-scale
point at 2048 ranks.  The numeric solve is compared within rtol 5e-5 /
atol 5e-6: the port loops over the swept axis where the reference runs an
associative scan, so float32 sums round in another order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.apps import kripke as ref_kripke
from repro.apps.stencil import Decomp3D as RefDecomp
from repro_torch.apps import kripke
from repro_torch.core import collectives as coll
from repro_torch.core import compat
from repro_torch.core.backend import BackendUnavailable, TorchBackend
from repro_torch.interop import kripke_config_from_dict

_SMALL = dict(nx=4, ny=4, nz=4)
CASES = {
    "partners-4x4x4": ((4, 4, 4), dict(_SMALL, n_octants=2, fuse_messages=False)),
    "36-messages": ((2, 2, 2), dict(_SMALL, n_octants=1, fuse_messages=False)),
    "fused-2x2x2": ((2, 2, 2), dict(_SMALL, n_octants=1, fuse_messages=True)),
    "weak-4x4x4": ((4, 4, 4), dict(_SMALL)),
    "parity-2x2x2": ((2, 2, 2), dict(_SMALL, n_octants=2, fuse_messages=False)),
    "scale-2048": (
        (16, 16, 8),
        dict(nx=16, ny=32, nz=32, n_octants=1, fuse_messages=True),
    ),
}


def _configs(shape, params):
    ref_cfg = ref_kripke.KripkeConfig(decomp=RefDecomp(*shape), **params)
    return ref_cfg, kripke_config_from_dict(dataclasses.asdict(ref_cfg))


@pytest.mark.parametrize("case", list(CASES))
def test_profile_byte_identical(case):
    ref_cfg, cfg = _configs(*CASES[case])
    assert cfg.decomp.shape == ref_cfg.decomp.shape and cfg.w == ref_cfg.w
    want = ref_kripke.profile(ref_cfg).to_json()
    got = kripke.profile(cfg, device="cpu")
    assert got.to_json() == want


def test_paper_findings_hold_in_the_port():
    _, cfg = _configs(*CASES["partners-4x4x4"])
    sc = kripke.profile(cfg, device="cpu").regions["sweep_comm"]
    assert sc.dest_ranks == (3, 6) and sc.src_ranks == (3, 6)
    _, cfg = _configs(*CASES["36-messages"])
    assert kripke.profile(cfg, device="cpu").regions["sweep_comm"].sends[1] == 108


def test_default_backend_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, cfg = _configs(*CASES["fused-2x2x2"])
    with pytest.raises(BackendUnavailable):
        kripke.profile(cfg)
    with pytest.raises(BackendUnavailable):
        kripke.make_source(cfg)


@pytest.mark.parametrize("n_octants", [1, 8])
def test_reference_sweep_matches_jax(n_octants):
    ref_cfg, cfg = _configs((1, 1, 1), dict(_SMALL, n_octants=n_octants))
    q = np.array(ref_kripke.make_source(ref_cfg))
    want = np.asarray(ref_kripke.reference_sweep(ref_cfg)(q))
    got = kripke.reference_sweep(cfg)(torch.from_numpy(q)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-6)


def test_make_source_matches_jax():
    ref_cfg, cfg = _configs((2, 1, 1), dict(_SMALL))
    for global_shape in (False, True):
        want = np.asarray(ref_kripke.make_source(ref_cfg, global_shape=global_shape))
        got = kripke.make_source(cfg, global_shape=global_shape, device="cpu")
        got = got.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_real_tensors_raise_without_a_process_group():
    """Without a process group of the mesh's ranks, real tensors are not
    executed: the driver and a bare collective raise (no single-rank
    fallback)."""
    _, cfg = _configs(*CASES["fused-2x2x2"])
    q = kripke.make_source(cfg, global_shape=True, device="cpu")
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        kripke.distributed_sweep(cfg, cfg.decomp.make_mesh())(q)
    with pytest.raises(RuntimeError, match="inside shard_map"):
        coll.psum(torch.ones(3), "x")


def test_shard_map_traces_local_shapes_on_meta():
    mesh = compat.make_mesh((2, 4), ("x", "y"))
    seen = {}

    def body(a):
        seen["local"] = tuple(a.shape)
        seen["x"] = compat.axis_size("x")
        seen["xy"] = compat.axis_size(("x", "y"))
        assert compat.axis_index("y").device.type == "meta"
        return coll.all_gather(a, "y", axis=0, tiled=True)[:2]

    spec = compat.PartitionSpec("x", "y")
    out = compat.shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec)(
        torch.empty(6, 8, device="meta")
    )
    assert seen == {"local": (3, 2), "x": 2, "xy": 8}
    assert tuple(out.shape) == (4, 8) and out.device.type == "meta"


def test_halo_exchange_profile_and_laplacian_match_jax():
    import jax
    import jax.numpy as jnp

    from repro.apps import stencil as ref_stencil
    from repro.core import comm_region as ref_region
    from repro.core import compat as ref_compat
    from repro.core.profiler import profile_traced as ref_traced
    from repro_torch.apps import stencil
    from repro_torch.core.profiler import profile_traced
    from repro_torch.core.regions import comm_region

    ref_dc = ref_stencil.Decomp3D(2, 2, 1)
    ref_mesh = ref_dc.make_mesh(abstract=True)

    def ref_run(u):
        def inner(u):
            with ref_region("halo"):
                ref_stencil.halo_exchange(u, ref_dc, periodic=True)
            return u

        spec = ref_dc.spec()
        return ref_compat.shard_map(
            inner, mesh=ref_mesh, in_specs=spec, out_specs=spec
        )(u)

    with ref_dc.topology():
        want = ref_traced(ref_run, jax.ShapeDtypeStruct((8, 8, 4), jnp.float32))

    dc = stencil.Decomp3D(2, 2, 1)
    spec = compat.PartitionSpec(*stencil.AXIS_NAMES)

    def run(u):
        def inner(u):
            with comm_region("halo"):
                stencil.halo_exchange(u, dc, periodic=True)
            return u

        mesh = dc.make_mesh()
        return compat.shard_map(inner, mesh=mesh, in_specs=spec, out_specs=spec)(u)

    with dc.topology():
        got = profile_traced(
            run, torch.empty(8, 8, 4), backend=TorchBackend(device="cpu")
        )
    assert got.to_json() == want.to_json()

    u = np.random.default_rng(27).random((6, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        stencil.laplacian_7pt(torch.from_numpy(u), h2=0.5).numpy(),
        np.asarray(ref_stencil.laplacian_7pt(jnp.asarray(u), h2=0.5)),
        rtol=1e-6,
        atol=1e-6,
    )
