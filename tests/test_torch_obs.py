"""The port's ``obs`` layer against the reference's ``repro.obs``, on the CPU.

1. The same metric and span sequence in both registries gives equal
   ``snapshot()``, ``prometheus_text``, ``phase_table`` and span trees.
2. A small bulk HNSW (then a copy-on-write add and delete through the
   handle), a bulk Vamana and an inline sharded build in each package
   emit the same span names and the same counter series (names and
   labels). The reference ticks some counters at trace time, so its
   compiled programs are dropped first.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import obs as jobs
from repro.graph.engine import BuildParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro.graph.sharded import ShardConfig as JShardConfig
from repro.graph.sharded import ShardedBuilder as JShardedBuilder
from repro.obs import report as jreport
from repro.serve.handle import IndexHandle as JHandle
from repro_torch import obs
from repro_torch.graph.engine import BuildParams
from repro_torch.index import AnnIndex, ShardConfig, ShardedBuilder
from repro_torch.obs import report
from repro_torch.serve.handle import IndexHandle
from conftest import make_clustered

PARAMS = dict(r_upper=8, r_base=16, ef=32, batch=16, max_layers=3)
FLASH_KW = dict(d_f=16, m_f=8, l_f=4, h=8, kmeans_iters=6)


@pytest.fixture
def both_on():
    """Both packages' obs enabled, their registries and spans empty."""
    was = (obs.enabled(), jobs.enabled())
    for m in (obs, jobs):
        m.enable()
        m.REGISTRY.clear()
        m.clear_spans()
    yield
    for m, on in zip((obs, jobs), was):
        m.REGISTRY.clear()
        m.clear_spans()
        m.enable() if on else m.disable()


def _drive(m):
    """One metric and span sequence through a package's obs API."""
    m.counter("req_total", route="a").inc()
    m.counter("req_total", route="a").inc(2)
    m.counter("req_total", route="b", inst="7").inc(5)
    m.tick("plain_total", n=3)
    m.tick("plain_total")
    m.gauge("depth", inst="0").set(4)
    m.gauge("depth", inst="0").inc(-1)
    h = m.histogram("lat_seconds", window=8, inst="0")
    for v in (0.003, 0.001, 0.002, 0.010, 0.0005, 0.004, 0.007, 0.009, 0.0002, 0.006):
        h.observe(v)
    with m.span("outer", a=1) as sp:
        sp.add_cost(10, 2)
        with m.span("outer/inner", b="x") as inner:
            inner.add_cost(np.float32(3.0))
        with m.span("outer/inner2"):
            pass
    with pytest.raises(TypeError, match="already registered"):
        m.gauge("req_total", route="a")
    return m.snapshot()


def _tree(sp):
    d = sp.to_dict()

    def strip(x):
        x.pop("dur_s")
        for c in x.get("children", ()):
            strip(c)
        return x

    return strip(d)


def test_same_sequence_same_snapshot_and_text(both_on):
    got, want = _drive(obs), _drive(jobs)
    assert got == want
    assert report.prometheus_text() == jreport.prometheus_text()
    assert report.prometheus_text(got) == jreport.prometheus_text(want)
    assert [_tree(s) for s in obs.spans()] == [_tree(s) for s in jobs.spans()]
    assert [s.name for s in obs.iter_spans()] == [s.name for s in jobs.iter_spans()]
    assert obs.pcts_ms([0.5, 0.1, 0.3]) == jobs.pcts_ms([0.5, 0.1, 0.3])
    pj, jj = report.json_dump(), jreport.json_dump()
    assert pj["metrics"] == jj["metrics"] and len(pj["spans"]) == len(jj["spans"])
    obs.REGISTRY.reset()
    jobs.REGISTRY.reset()
    assert obs.snapshot() == jobs.snapshot()


def test_phase_table_equal(both_on):
    class Stats:
        n_dists = 1234.0
        phases = np.asarray([100.0, 200.0, 900.0, 34.0, 0.0])

    spans = []
    for m in (obs, jobs):
        sp = m.Span("build/repair", {})
        sp.dur_s, sp.n_dists = 0.25, 34.0
        spans.append([sp])
    assert report.phase_table(Stats()) == jreport.phase_table(Stats())
    assert report.phase_table(Stats(), spans=spans[0]) == jreport.phase_table(Stats(), spans=spans[1])


def test_disabled_records_nothing():
    was = obs.enabled()
    obs.disable()
    try:
        obs.clear_spans()
        with obs.span("never") as sp:
            assert sp is obs.NULL_SPAN
            sp.add_cost(object())  # never float()-ed
        obs.tick("never_total")
        assert obs.spans() == [] and "never_total" not in obs.snapshot()["counters"]
    finally:
        obs.enable() if was else obs.disable()


def _series(m):
    """(span names, counter series). ``kernel_traces_total`` counts the
    reference's XLA traces and has no counterpart in the port (its launch
    count is ``ops.launches``)."""
    counters = {k for k in m.snapshot()["counters"] if not k.startswith("kernel_traces_total")}
    return {s.name for s in m.iter_spans()}, counters


def test_builds_emit_same_spans_and_series(both_on, tmp_path):
    x = make_clustered(700, 16, n_clusters=12, seed=23)
    base, extra = x[:640], x[640:]
    jax.clear_caches()  # the reference ticks beam_dispatch_total at trace time
    jp, pp = JParams(**PARAMS), BuildParams(**PARAMS)
    jidx = JIndex.build(jnp.asarray(base), algo="hnsw", backend="flash_blocked", params=jp,
                        backend_kwargs=FLASH_KW, strategy="bulk")
    meta, arrays = jidx.export_state()
    port = AnnIndex.restore(meta, {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")
    AnnIndex.build(base, algo="hnsw", backend="flash_blocked", params=pp, backend_kwargs=FLASH_KW,
                   strategy="bulk", device="cpu")
    for handle, ext in ((JHandle(jidx), jnp.asarray(extra)), (IndexHandle(port), extra)):
        handle.add(ext)
        handle.delete([1, 2])
        handle.compact()
    got, want = _series(obs), _series(jobs)
    assert got[0] == want[0], got[0] ^ want[0]
    assert got[1] == want[1], got[1] ^ want[1]
    assert {"build", "build/bulk_refine", "build/bulk_commit", "build/repair", "build/add",
            "build/compact", "serve/flip", "serve/flip/clone", "serve/flip/apply",
            "serve/flip/prepare"} <= got[0]
    assert 'beam_dispatch_total{route="fused"}' in got[1] and "serve_flips_total" in got[1]

    for m in (obs, jobs):
        m.REGISTRY.clear()
        m.clear_spans()
    JIndex.build(jnp.asarray(base), algo="vamana", backend="flash_blocked", params=jp,
                 backend_kwargs=FLASH_KW, strategy="bulk")
    AnnIndex.build(base, algo="vamana", backend="flash_blocked", params=pp, backend_kwargs=FLASH_KW,
                   strategy="bulk", device="cpu")
    assert _series(obs) == _series(jobs)

    for m in (obs, jobs):
        m.REGISTRY.clear()
        m.clear_spans()
    kw = dict(n_segments=2, chunk_size=256, backend="flash_blocked", backend_kwargs=FLASH_KW,
              sample_size=512, strategy="incremental")
    JShardedBuilder(JShardConfig(params=jp, **kw), workdir=str(tmp_path / "j")).build(base)
    ShardedBuilder(ShardConfig(params=pp, **kw), workdir=str(tmp_path / "p"), device="cpu").build(base)
    got, want = _series(obs), _series(jobs)
    assert got == want
    assert {"shard/assign", "shard/build", "shard/segment"} <= got[0]
    assert 'shard_segment_vectors_total' in {k.split("{")[0] for k in got[1]}


def test_report_cli_runs_on_cpu(capsys):
    was = obs.enabled()
    try:
        assert report.main(["--n", "400", "--d", "16", "--queries", "20", "--device", "cpu"]) == 0
    finally:
        obs.enable() if was else obs.disable()
        obs.clear_spans()
    out = capsys.readouterr().out
    assert "exact partition: True" in out and "serve_admission_total" in out
    assert "flip gen 0 -> 1" in out
