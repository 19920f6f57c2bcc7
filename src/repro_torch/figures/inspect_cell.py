"""Deep-dive one dry-run cell: top byte and collective contributors.

The port of ``benchmarks/inspect_cell.py``: no device, it reads the graph
the dry run captures (:func:`repro_torch.launch.dryrun.lower_cell`).

    python -m repro_torch.figures.inspect_cell --arch xlstm-1.3b \\
        --shape train_4k [--override seq=None ...]
"""

from __future__ import annotations

import argparse

from repro_torch.core.hlo_cost import node_bytes, node_value, tensors_in


def _type(value) -> str:
    """``dtype[dims]`` of a node's value (its first tensor's)."""
    ts = tensors_in(value)
    if not ts:
        return ""
    t = ts[0]
    return f"{str(t.dtype).removeprefix('torch.')}[{','.join(map(str, t.shape))}]"


def top_bytes(gm, k: int = 25) -> list:
    """The ``k`` nodes of a captured graph that move the most bytes
    (``hlo_cost.node_bytes``: operands + results of a kernel-launching
    node), largest first: (bytes, aten op, node name, result type, region
    path)."""
    graph = getattr(gm, "graph", gm)
    items = []
    for node in graph.nodes:
        b = node_bytes(node)
        if not b:
            continue
        op = getattr(node.target, "__name__", str(node.target))
        region = node.meta.get("custom", {}).get("comm_region", "")
        items.append((b, op, node.name, _type(node_value(node))[:48], region[-80:]))
    items.sort(key=lambda it: -it[0])
    return items[:k]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--override", nargs="*", default=[],
                    help="logical=meshaxis (e.g. seq=None heads=model)")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=")
        overrides[k] = (None if v in ("None", "none") else
                        tuple(v.split("+")) if "+" in v else v)

    from repro_torch.launch.dryrun import lower_cell

    rec, gm = lower_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                         plan_overrides=overrides or None)
    rf = rec["roofline"]
    print(f"plan: {rec['plan']}")
    print(f"terms: compute={rf['compute_s']:.3f}s memory="
          f"{rf['memory_s']:.3f}s collective={rf['collective_s']:.3f}s  "
          f"dominant={rf['dominant']}  frac={rf['roofline_fraction']:.4f}")
    print(f"mem/device: {rec['memory']['total_bytes'] / 2**30:.2f} GiB")
    print("\ncollectives by region (wire GiB):")
    for k, (n, b) in sorted(rec["collectives"]["by_region"].items(),
                            key=lambda kv: -kv[1][1]):
        print(f"  {k:16s} n={n:4d} {b / 2**30:9.2f}")
    print(f"\ntop {args.top} byte contributors "
          f"(bytes, aten op, node, type, region path):")
    for it in top_bytes(gm, args.top):
        print(f"  {it[0]:.3e} {it[1][:34]:34s} {it[2][:24]:24s} {it[3]:48s} {it[4]}")


if __name__ == "__main__":
    main()
