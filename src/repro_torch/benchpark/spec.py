"""Benchpark analog — reproducible experiment specifications.

Benchpark (paper §II) encodes benchmark × system × scaling configurations so
experiments are reproducible across machines.  Here an ExperimentSpec is a
declarative description of a scaling study over one of the three apps; the
runner materializes each point as a config, profiles it (trace-only: the
per-rank program runs once on ``meta`` tensors, so no rank needs a device),
reduces the trace on the CUDA card, and stores CommProfile JSONs.

The paper's own experiments (Table III) ship as ``PAPER_EXPERIMENTS``
(64..512 ranks, the published Dane/Tioga rows).  ``SCALE_EXPERIMENTS``
extends each app into the lazily-materialized trace store's regime —
2048 through 131072 ranks — now that struct payloads are
rank-extent-normalized generator fingerprints materialized per reduction
(see ``repro_torch.core.regions``); the smoke sweep runs the apps at up
to 8192 ranks from these specs, and the 32k+ points stay offline.  The
``beatnik`` app (global far-field coupling, per-step structure mutation)
rides along as the interning worst case.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.apps.stencil import Decomp3D


@dataclass(frozen=True)
class ScalePoint:
    decomp: tuple  # (px, py, pz)
    label: str = ""

    @property
    def n_ranks(self) -> int:
        px, py, pz = self.decomp
        return px * py * pz


@dataclass(frozen=True)
class ExperimentSpec:
    name: str
    app: str  # kripke | amg | laghos | beatnik
    scaling: str  # weak | strong
    points: tuple  # ScalePoints
    app_params: dict = field(default_factory=dict)
    system: str = "dgx-h100"
    # roofline seconds per step are attached by the runner (from the H100
    # datasheet constants in ``runner``) so bandwidth / message-rate
    # metrics (paper §V) can be derived

    def configs(self):
        from repro_torch.apps.amg import AMGConfig
        from repro_torch.apps.beatnik import BeatnikConfig
        from repro_torch.apps.kripke import KripkeConfig
        from repro_torch.apps.laghos import LaghosConfig

        out = []
        for pt in self.points:
            dc = Decomp3D(*pt.decomp)
            if self.app == "kripke":
                cfg = KripkeConfig(decomp=dc, **self.app_params)
            elif self.app == "amg":
                cfg = AMGConfig(decomp=dc, **self.app_params)
            elif self.app == "laghos":
                params = dict(self.app_params)
                if self.scaling == "strong":
                    pass  # global size fixed in app_params
                cfg = LaghosConfig(decomp=dc, **params)
            elif self.app == "beatnik":
                cfg = BeatnikConfig(decomp=dc, **self.app_params)
            else:
                raise ValueError(self.app)
            out.append((pt, cfg))
        return out


# ---------------------------------------------------------------------------
# The paper's experiments (Table III), adapted: same process counts and
# decompositions as the Dane rows; per-rank problem sizes as published
# (Kripke 16x32x32, AMG 32x32x16).
# ---------------------------------------------------------------------------

_DANE_POINTS = (
    ScalePoint((4, 4, 4)),
    ScalePoint((8, 4, 4)),
    ScalePoint((8, 8, 4)),
    ScalePoint((8, 8, 8)),
)
_TIOGA_POINTS = (
    ScalePoint((2, 2, 2)),
    ScalePoint((4, 2, 2)),
    ScalePoint((4, 4, 2)),
    ScalePoint((4, 4, 4)),
)

PAPER_EXPERIMENTS = {
    "kripke-weak-dane": ExperimentSpec(
        name="kripke-weak-dane",
        app="kripke",
        scaling="weak",
        points=_DANE_POINTS,
        app_params=dict(nx=16, ny=32, nz=32, n_octants=2, fuse_messages=False),
    ),
    "kripke-weak-tioga": ExperimentSpec(
        name="kripke-weak-tioga",
        app="kripke",
        scaling="weak",
        points=_TIOGA_POINTS,
        app_params=dict(nx=16, ny=32, nz=32, n_octants=2, fuse_messages=False),
    ),
    "amg-weak-dane": ExperimentSpec(
        name="amg-weak-dane",
        app="amg",
        scaling="weak",
        points=_DANE_POINTS,
        app_params=dict(nx=32, ny=32, nz=16),
    ),
    "amg-weak-tioga": ExperimentSpec(
        name="amg-weak-tioga",
        app="amg",
        scaling="weak",
        points=_TIOGA_POINTS,
        app_params=dict(nx=32, ny=32, nz=16),
    ),
    "laghos-strong": ExperimentSpec(
        name="laghos-strong",
        app="laghos",
        scaling="strong",
        points=(
            ScalePoint((4, 4, 1)),
            ScalePoint((8, 4, 1)),
            ScalePoint((8, 8, 1)),
            ScalePoint((16, 8, 1)),
        ),
        app_params=dict(nx=512, ny=512, n_steps=2),
    ),
}


# ---------------------------------------------------------------------------
# Beyond-paper scale: 2048 through 131072 ranks.  z stays <= 8 wide so the
# AMG hierarchy bottoms out exactly like the published Dane rows (the
# gathered coarse level is reached at global z = 8); kripke traces its
# fused message path (one permute per axis phase instead of one per
# direction set and group set), one octant, so the traced graph grows
# with stage count, not message count.  The smoke sweep
# (``repro_torch.figures.run --smoke``) runs up to 8192 ranks; the 32k+
# points stay offline.
# ---------------------------------------------------------------------------

_SCALE_POINTS_3D = (
    ScalePoint((16, 16, 8)),  # 2048
    ScalePoint((32, 16, 8)),  # 4096
    ScalePoint((32, 32, 8)),  # 8192
    ScalePoint((64, 64, 8)),  # 32768
    ScalePoint((128, 64, 8)),  # 65536
    ScalePoint((128, 128, 8)),  # 131072
)

SCALE_EXPERIMENTS = {
    "kripke-weak-scale": ExperimentSpec(
        name="kripke-weak-scale",
        app="kripke",
        scaling="weak",
        points=_SCALE_POINTS_3D,
        app_params=dict(nx=16, ny=32, nz=32, n_octants=1, fuse_messages=True),
    ),
    "amg-weak-scale": ExperimentSpec(
        name="amg-weak-scale",
        app="amg",
        scaling="weak",
        points=_SCALE_POINTS_3D,
        app_params=dict(nx=32, ny=32, nz=16),
    ),
    "laghos-strong-scale": ExperimentSpec(
        name="laghos-strong-scale",
        app="laghos",
        scaling="strong",
        points=(
            ScalePoint((64, 32, 1)),  # 2048
            ScalePoint((64, 64, 1)),  # 4096
            ScalePoint((128, 64, 1)),  # 8192
            ScalePoint((256, 128, 1)),  # 32768
            ScalePoint((256, 256, 1)),  # 65536
            ScalePoint((512, 256, 1)),  # 131072
        ),
        app_params=dict(nx=512, ny=512, n_steps=2),
    ),
    # The interning worst case: global far-field collectives couple every
    # rank and the migration permute mutates per step — almost nothing
    # dedups, keeping the lazy-materialization fast path honest.
    "beatnik-weak-scale": ExperimentSpec(
        name="beatnik-weak-scale",
        app="beatnik",
        scaling="weak",
        points=(
            ScalePoint((32, 64, 1)),  # 2048
            ScalePoint((64, 64, 1)),  # 4096
            ScalePoint((128, 64, 1)),  # 8192
        ),
        app_params=dict(nx=32, ny=32, n_steps=4),
    ),
}
