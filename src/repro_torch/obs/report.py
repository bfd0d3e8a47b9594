"""Report rendering + the ``python -m repro_torch.obs.report`` CLI (the port's
copy of ``repro.obs.report``).

Three renderers over the observability layer's state:

  * :func:`prometheus_text` — Prometheus text exposition of a registry
    snapshot (counters, gauges, histogram count/sum/window percentiles).
  * :func:`phase_table` — the paper's "where does indexing time go" table
    from a build's per-phase distance split (``BuildStats.phases``) and the
    recorded build spans' wall time.
  * :func:`json_dump` — one structured JSON object (metrics + spans) for
    artifact upload / offline diffing.

The CLI is a self-contained demo of the whole layer: it enables obs, runs
a ``strategy="bulk"`` build, serves queries through the continuous-batching
:class:`~repro_torch.serve.runtime.Runtime` with a mixed add/delete
mutation workload on ``--device`` (the card unless the caller asks for
the CPU), then prints the phase table (whose per-phase ``n_dists`` sum to
the build's ``n_dists`` exactly), the generation-flip spans, and the
Prometheus exposition. Heavy imports (``repro_torch.graph``,
``repro_torch.serve``) happen lazily inside :func:`main` — the renderers
import only the obs package itself.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import registry as _registry
from repro_torch.obs import trace as _trace


def prometheus_text(snapshot: dict | None = None) -> str:
    """Render a registry snapshot in Prometheus text exposition format."""
    snap = _registry.REGISTRY.snapshot() if snapshot is None else snapshot
    lines: list[str] = []
    for key, value in sorted(snap.get("counters", {}).items()):
        lines.append(f"{key} {value}")
    for key, value in sorted(snap.get("gauges", {}).items()):
        lines.append(f"{key} {value}")
    for key, h in sorted(snap.get("histograms", {}).items()):
        name, _, labels = key.partition("{")
        labels = ("{" + labels) if labels else ""
        inner = labels[1:-1] if labels else ""
        sep = "," if inner else ""
        lines.append(f"{name}_count{labels} {h['count']}")
        lines.append(f"{name}_sum{labels} {h['sum']}")
        for q, v in (("0.5", h["p50_ms"]), ("0.99", h["p99_ms"])):
            lines.append(
                f'{name}_ms{{{inner}{sep}quantile="{q}"}} {v}'
            )
    return "\n".join(lines) + ("\n" if lines else "")


def phase_table(stats, *, spans: list | None = None) -> str:
    """Render a build's per-phase distance split as an aligned text table.

    ``stats`` is anything with ``n_dists`` and ``phases`` (a
    :class:`~repro_torch.graph.engine.BuildStats`). When build spans are
    available (obs enabled during the build), wall time per recorded span
    name is appended below the phase rows.
    """
    import numpy as np

    from repro_torch.graph.engine import PHASE_NAMES

    total = float(stats.n_dists)
    rows = []
    if getattr(stats, "phases", None) is not None:
        phases = np.asarray(stats.phases, np.float64)
        for name, v in zip(PHASE_NAMES, phases):
            share = (100.0 * v / total) if total else 0.0
            rows.append((name, float(v), share))
        psum = float(phases.sum())
    else:
        psum = float("nan")
    out = ["phase            n_dists        share"]
    for name, v, share in rows:
        out.append(f"{name:<14} {v:>12.0f} {share:>11.1f}%")
    out.append(f"{'sum(phases)':<14} {psum:>12.0f}")
    out.append(f"{'n_dists':<14} {total:>12.0f}")
    exact = psum == total
    out.append(f"exact partition: {exact}")
    if spans:
        out.append("")
        out.append("span                     wall_s      n_dists")
        for sp in spans:
            out.append(f"{sp.name:<22} {sp.dur_s:>9.3f} {sp.n_dists:>12.0f}")
    return "\n".join(out)


def json_dump(*, snapshot: dict | None = None) -> dict:
    """One structured object: registry snapshot + finished root spans."""
    return {
        "metrics": (
            _registry.REGISTRY.snapshot() if snapshot is None else snapshot
        ),
        "spans": [sp.to_dict() for sp in _trace.spans()],
    }


def _flatten_spans(roots):
    todo = list(roots)
    while todo:
        sp = todo.pop(0)
        yield sp
        todo[:0] = sp.children


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description=(
            "Observability demo: bulk-build an index, serve a mixed "
            "workload through the Runtime, and print the phase table, "
            "flip spans, and Prometheus exposition."
        ),
    )
    parser.add_argument("--n", type=int, default=2000, help="corpus size")
    parser.add_argument("--d", type=int, default=32, help="dimensionality")
    parser.add_argument(
        "--queries", type=int, default=100, help="queries served"
    )
    parser.add_argument(
        "--device", default="cuda", help="torch device (default: the card)",
    )
    parser.add_argument(
        "--json", metavar="PATH", default=None,
        help="also write the structured JSON dump here",
    )
    parser.add_argument(
        "--trace", metavar="PATH", default=None,
        help="also export finished spans as JSON lines here",
    )
    args = parser.parse_args(argv)

    _trace.enable()
    _trace.clear_spans()

    import numpy as np

    from repro_torch.graph.index import AnnIndex
    from repro_torch.serve.runtime import Runtime

    rng = np.random.default_rng(0)
    data = rng.normal(size=(args.n, args.d)).astype(np.float32)
    queries = rng.normal(size=(args.queries, args.d)).astype(np.float32)

    print(f"== build (bulk, n={args.n}, d={args.d}) ==")
    index = AnnIndex.build(
        data, algo="hnsw", strategy="bulk",
        backend_kwargs=dict(
            d_f=min(32, args.d), m_f=16, l_f=4, h=8, kmeans_iters=10
        ),
        device=args.device,
    )
    stats = index.last_stats
    build_spans = list(_flatten_spans(_trace.spans("build")))
    print(phase_table(stats, spans=build_spans))

    print(f"\n== serve ({args.queries} queries + mutations) ==")
    with Runtime(index, k=10, ef=64) as rt:
        rt.warmup()
        futs = [rt.submit(q) for q in queries[: args.queries // 2]]
        rt.add(rng.normal(size=(8, args.d)).astype(np.float32)).result()
        rt.delete(np.arange(4)).result()
        futs += [rt.submit(q) for q in queries[args.queries // 2:]]
        for f in futs:
            f.result()
        rt_stats = rt.stats()
    print(f"served={rt_stats['served']} generation={rt_stats['generation']} "
          f"cold_dispatches={rt_stats['cold_dispatches']} "
          f"p50_ms={rt_stats['p50_ms']:.2f} p99_ms={rt_stats['p99_ms']:.2f}")
    flips = _trace.spans("serve/flip")
    for sp in flips:
        parts = {c.name.rsplit("/", 1)[-1]: c.dur_s for c in sp.children}
        print(
            f"flip gen {sp.attrs.get('base_gen')} -> {sp.attrs.get('gen')}: "
            f"{sp.dur_s:.3f}s ("
            + ", ".join(f"{k}={v:.3f}s" for k, v in parts.items())
            + ")"
        )

    print("\n== prometheus exposition ==")
    print(prometheus_text(), end="")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(json_dump(), f, indent=2)
        print(f"\nwrote {args.json}")
    if args.trace:
        n = _trace.export_jsonl(args.trace)
        print(f"wrote {n} root spans to {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
