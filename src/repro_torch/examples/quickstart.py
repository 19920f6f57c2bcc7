"""Quickstart: the paper's workflow end to end on the port.

    python -m repro_torch.examples.quickstart [--device cpu] [--backend numpy]

1. annotate communication regions in a domain-decomposed app (Kripke),
2. profile its MPI-analog traffic at paper scale (64 ranks — the per-rank
   program is traced once on ``meta`` tensors, so no rank needs a device;
   the trace is reduced on the CUDA card unless the command line asks for
   the host),
3. print the Table-I-schema statistics and the corner-vs-interior finding,
   then the modeled network layer and a halo heatmap,
4. re-profile the same trace **incrementally** (live monitoring): consume
   the TraceBuffer in watermark deltas, publish the mergeable summary
   shards, and let a ``SweepAggregator`` rebuild the batch profile
   byte-for-byte — the mechanism behind ``python -m
   repro_torch.figures.run --live`` and the ``live_dir=`` mode of the
   benchpark runner.

Every reduction below runs on the backend the command line picks (torch on
the card by default, ``--device cpu`` or ``--backend numpy`` on the host);
profiles are byte-identical on every backend.  The JAX package's
quickstart also profiles a compiled sharded LM train step; that section
waits for the port's HLO producer.
"""

import tempfile

from repro_torch.apps.kripke import KripkeConfig
from repro_torch.apps.kripke import profile as kripke_profile
from repro_torch.apps.stencil import Decomp3D
from repro_torch.benchpark.aggregator import SweepAggregator, publish_shard
from repro_torch.core.backend import use_backend
from repro_torch.core.network import FAT_TREE, RING, ascii_heatmap, peer_heatmap
from repro_torch.core.profiler import CommPatternProfiler, trace_observer
from repro_torch.core.reports import (
    network_vs_traced,
    region_stats_table,
    table1_schema,
)
from repro_torch.core.thicket import Frame
from repro_torch.examples._args import parse_backend


def main() -> None:
    backend = parse_backend(__doc__.split("\n\n")[0])
    with use_backend(backend):
        run()


def run() -> None:
    print("== Table I — attributes the profiler collects ==")
    print(table1_schema())

    print("\n== Kripke sweep at 4x4x4 = 64 ranks (paper Dane point) ==")
    cfg = KripkeConfig(
        decomp=Decomp3D(4, 4, 4),
        nx=16,
        ny=32,
        nz=32,
        n_octants=2,
        fuse_messages=False,
    )
    prof = kripke_profile(cfg)
    print(region_stats_table(prof))
    sc = prof.regions["sweep_comm"]
    print(
        f"\ncommunication partners per rank: min={sc.dest_ranks[0]} "
        f"(corner), max={sc.dest_ranks[1]} (interior) — paper §IV-A"
    )
    print(
        f"messages per phase per partner: "
        f"{cfg.n_dirsets * cfg.n_groupsets} — paper's 36"
    )

    print("\n== layer='network': modeled fabric cost + halo heatmap ==")
    # The third analysis layer needs no devices either: each unique
    # communication structure in the trace maps onto a parameterized
    # fabric model (ring / fat-tree / dragonfly latency–bandwidth with
    # link contention from overlapping peer pairs), giving per-region
    # modeled wire time, hop counts, and congestion — O(unique structs),
    # never per-event.  Fabric parameters are dataclass fields:
    # FabricModel(name="ring", latency_s=1e-6, bandwidth_Bps=50e9).
    holder = {}

    def keep_recorder(rec, *, name, replication, meta):
        holder["rec"] = rec
        return None  # fall through to the batch reduction

    with trace_observer(keep_recorder):
        prof64 = kripke_profile(cfg, name="kripke-64")
    rec = holder["rec"]
    heat = peer_heatmap(rec, region="sweep_comm", bins=16)
    print(ascii_heatmap(heat, title="sweep_comm peer pairs (16x16 bins)"))
    entries = [("kripke-64", 64, rec, fab) for fab in (RING, FAT_TREE)]
    print(network_vs_traced([prof64], entries))
    net = Frame.from_network(entries).where(region="sweep_comm")
    for r in net:
        print(
            f"  {r['net_fabric']:9s} wire={r['net_wire_s']:.3e}s "
            f"hops_max={r['net_hops_max']} congestion={r['net_congestion']:.2f}"
        )
    # repro_torch.figures.fig8_halo_heatmap renders these heatmaps + modeled-
    # congestion scaling for all four apps.

    print("\n== Live monitoring: the same profile, streamed in deltas ==")
    # A sweep worker doesn't have to wait for the trace to finish: under a
    # trace_observer hook, profile() hands the recorder to the incremental
    # profiler, which re-reduces only the rows recorded since its
    # (row, multiplicity) watermark.  The deltas are mergeable shards a
    # SweepAggregator can combine in any order or tree shape; a complete
    # shard set reproduces the batch profile byte-for-byte.
    shards = []

    def streaming_observer(rec, *, name, replication, meta):
        sp = CommPatternProfiler.incremental(rec)
        n = rec.buffer.n_rows
        for cut in (n // 3, 2 * n // 3, None):
            delta = sp.update(cut)
            if delta.n_events or delta.instances:
                shards.append(delta)
        print(f"  consumed trace in {len(shards)} deltas, watermark {sp.watermark}")
        return sp.profile(name=name, replication=replication, meta=meta)

    with trace_observer(streaming_observer):
        live = kripke_profile(cfg)
    with tempfile.TemporaryDirectory() as shard_dir:
        for i, d in enumerate(shards):
            publish_shard(
                shard_dir,
                point="kripke-00064",
                seq=i,
                total=len(shards),
                summary=d,
                name=live.name,
                meta=live.meta,
            )
        agg = SweepAggregator(shard_dir)
        agg.ingest()
        merged = agg.profile("kripke-00064")
    print(
        f"  streamed == batch: {live.to_json() == prof.to_json()}; "
        f"aggregated == batch: {merged.to_json() == prof.to_json()}"
    )


if __name__ == "__main__":
    main()
