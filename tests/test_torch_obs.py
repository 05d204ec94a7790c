"""The port's observability layer (``repro_torch.obs``: session, export,
the trace CLI) against the JAX package's (``repro.obs``), on the CPU.

Each case opens a session in each package (the two have separate metric
registries, recorder ContextVars and memo tables, so neither records the
other's events) and compares with ``==``: ``Report``\\ s, the recorded
summaries, lanes and events, ``reconcile`` verdicts, the Chrome trace's
simulator lanes and ``otherData``, metric values and the trace CLI's JSON
document.  Span events carry wall-clock times, so they are compared by name
and nesting only.  Mirrors ``tests/test_obs.py`` but its benchmark-harness
cases (``benchmarks/`` is not ported)."""

import json

import pytest

pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402
from test_torch_core import plain  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import isa as jisa  # noqa: E402
from repro.core import kernels_isa as jkisa  # noqa: E402
from repro.core import timing as jtiming  # noqa: E402
from repro.perf import memo as jmemo  # noqa: E402
from repro_torch import api, obs  # noqa: E402
from repro_torch.core import isa, kernels_isa, timing  # noqa: E402
from repro_torch.perf import memo  # noqa: E402

#: (api, obs, isa, kernels_isa, timing, memo) of each package.
PORT = (api, obs, isa, kernels_isa, timing, memo)
JAX = (japi, jobs, jisa, jkisa, jtiming, jmemo)


def _clear_memos():
    memo.clear_all()
    jmemo.clear_all()


def _random_body(Instr, spec):
    """The instruction body ``tests/test_timing_energy.py`` draws, built
    from either package's ``Instr``."""
    ops = ("add", "xor", "mul", "srli", "lw", "sw",
           "fadd.d", "fmul.d", "fmadd.d")
    body = []
    for sel, a, b in spec:
        op = ops[sel % len(ops)]
        if op == "lw":
            body.append(Instr("lw", f"r{a % 6}",
                              (f"loop:p{b % 3}", f"mem:m{b % 3}")))
        elif op == "sw":
            body.append(Instr("sw", f"mem:m{b % 3}", (f"r{a % 6}",)))
        elif op.startswith("f"):
            body.append(Instr(op, f"f{a % 6}", (f"f{b % 6}", "const:c")))
        else:
            body.append(Instr(op, f"r{a % 6}", (f"r{b % 6}",)))
    return body


def _sim_bundle(pkg, spec, iters, block, contention):
    """Every traced timing front door over one drawn body."""
    _, _, isa_, _, timing_, _ = pkg
    body = _random_body(isa_.Instr, spec)
    fp_body = [isa_.Instr("fmadd.d", "facc", ("facc", "loop:ssr0",
                                               "const:c"))] + \
        [i for i in body if i.opcode.startswith("f")][:4]
    sched = timing_.CopiftSchedule("prop", int_body=list(body),
                                   fp_bodies=[list(fp_body)])
    return (timing_.simulate_single_issue(body, iters),
            timing_.thread_cycles(body, iters, contention),
            timing_.copift_block_timing(sched, block, contention),
            timing_.copift_problem_timing(sched, 8 * block, block))


def _recorded(rec) -> dict:
    """What a recorder holds in the simulated cycle domain — everything
    but the spans' wall-clock times."""
    return dict(events=list(rec.events), lane_micro=rec.lane_micro,
                summaries=rec.summaries, block_records=rec.block_records,
                memo_provenance=dict(rec.memo_provenance),
                dropped_events=rec.dropped_events,
                spans=[(s["name"], s["depth"], s["memo_provenance"])
                       for s in rec.spans])


def _trace_parts(doc) -> tuple:
    """A Chrome-trace document split into the deterministic part (the
    simulator's events and metadata, ``otherData`` but ``metrics``) and the
    span events by name and nesting."""
    sim = [e for e in doc["traceEvents"] if e.get("cat") != "span"]
    spans = [(e["name"], e["args"]["depth"]) for e in doc["traceEvents"]
             if e.get("cat") == "span"]
    other = {k: v for k, v in doc["otherData"].items() if k != "metrics"}
    return sim, spans, other


def _traced(pkg, fn, **session_kw):
    """``fn(api)`` inside a fresh session of ``pkg``'s ``obs``."""
    with pkg[1].session(**session_kw) as sess:
        out = fn(pkg[0])
    return sess, out


def _both(fn, **session_kw):
    """``fn`` traced in each package from cleared memos:
    ((port session, result), (JAX session, result))."""
    _clear_memos()
    mine = _traced(PORT, fn, **session_kw)
    theirs = _traced(JAX, fn, **session_kw)
    return mine, theirs


# ---------------------------------------------------------------------------
# 1. Trace-vs-cold parity
# ---------------------------------------------------------------------------

class TestTracedParity:
    @settings(max_examples=10, deadline=None)
    @given(spec=st.lists(st.tuples(st.integers(0, 8), st.integers(0, 5),
                                   st.integers(0, 5)),
                         min_size=1, max_size=14),
           iters=st.integers(1, 24),
           block=st.sampled_from((1, 2, 7, 8, 16, 33)),
           contention=st.sampled_from((0.0, 0.25, 0.4375)))
    def test_property_traced_equals_untraced(self, spec, iters, block,
                                             contention):
        """Traced equals untraced with the memo bypassed, cold and warm,
        in the port; the numbers and the provenance equal the JAX
        package's."""
        args = (spec, iters, block, contention)
        with jmemo.memo_disabled():
            jtruth = _sim_bundle(JAX, *args)
        with memo.memo_disabled():
            truth = _sim_bundle(PORT, *args)
            with obs.session(trace=True, metrics=True):
                traced_nomemo = _sim_bundle(PORT, *args)
        assert traced_nomemo == truth
        assert plain(truth) == plain(jtruth)
        _clear_memos()
        with obs.session(trace=True, metrics=True) as s1:
            traced_cold = _sim_bundle(PORT, *args)
        with obs.session(trace=True, metrics=True) as s2:
            traced_warm = _sim_bundle(PORT, *args)
        with jobs.session(trace=True, metrics=True) as j1:
            _sim_bundle(JAX, *args)
        assert traced_cold == traced_warm == _sim_bundle(PORT, *args) \
            == truth
        assert s1.recorder.memo_provenance["cold"] > 0
        assert s2.recorder.memo_provenance["hit"] > 0
        assert s2.recorder.memo_provenance["cold"] == 0
        assert _recorded(s1.recorder) == _recorded(j1.recorder)

    @pytest.mark.parametrize("name", ("expf", "pi_lcg"))
    def test_registry_kernels_traced_equals_cold(self, name):
        def run(pkg):
            k = pkg[3]
            return pkg[4].evaluate_kernel(name, k.baseline_trace(name),
                                          k.copift_schedule(name), 64)
        with memo.memo_disabled():
            truth = run(PORT)
        (s, cold), (js, jcold) = _both(lambda a: run(
            PORT if a is api else JAX))
        with obs.session():
            warm = run(PORT)
        assert cold == warm == truth
        assert plain(cold) == plain(jcold)
        assert _recorded(s.recorder) == _recorded(js.recorder)

    def test_traced_run_does_not_poison_memo(self):
        sched = kernels_isa.copift_schedule("expf")
        memo.clear_all()
        with obs.session():
            traced = timing.copift_block_timing(sched, 64)
        after_traced = {s["name"]: s["entries"] for s in memo.stats()}
        memo.clear_all()
        untraced = timing.copift_block_timing(sched, 64)
        after_untraced = {s["name"]: s["entries"] for s in memo.stats()}
        assert traced == untraced
        assert after_traced == after_untraced
        assert timing.copift_block_timing(sched, 64) == untraced


# ---------------------------------------------------------------------------
# 2. Report parity + exact reconciliation through api.evaluate
# ---------------------------------------------------------------------------

TARGETS = {
    "single_pe": lambda a: a.Target.single_pe(),
    "homogeneous8": lambda a: a.Target.homogeneous(n_cores=8),
    "heterogeneous": lambda a: a.Target.heterogeneous(
        "2@1.45GHz@1.00V,6@0.50GHz@0.60V"),
}


class TestEvaluateTraceReconcile:
    @pytest.mark.parametrize("target_name", sorted(TARGETS))
    def test_report_parity_and_exact_reconcile(self, target_name):
        mk = TARGETS[target_name]
        memo.clear_all()
        untraced = api.evaluate("expf", mk(api))
        (sess, rep), (jsess, jrep) = _both(
            lambda a: a.evaluate("expf", mk(a)))
        with obs.session() as warm:
            rep_warm = api.evaluate("expf", mk(api))
        assert rep == untraced == rep_warm
        assert plain(rep) == plain(jrep)
        res, jres = sess.reconcile(rep), jsess.reconcile(jrep)
        assert res["ok"], [c for c in res["checks"] if not c["ok"]]
        assert res == jres
        assert warm.reconcile(rep_warm)["ok"]
        assert _recorded(sess.recorder) == _recorded(jsess.recorder)

    def test_reconcile_accepts_exported_dict(self):
        (sess, rep), (jsess, jrep) = _both(
            lambda a: a.evaluate("expf", a.Target.homogeneous(n_cores=4)))
        roundtrip = json.loads(json.dumps(sess.trace_dict()))
        jroundtrip = json.loads(json.dumps(jsess.trace_dict()))
        res = obs.reconcile(roundtrip, rep)
        assert res["ok"]
        assert res == jobs.reconcile(jroundtrip, jrep)

    def test_reconcile_flags_tampered_summary(self):
        (sess, rep), (jsess, jrep) = _both(
            lambda a: a.evaluate("expf", a.Target.homogeneous(n_cores=2)))
        sess.recorder.summaries[-1]["cycles_copift"] += 1
        jsess.recorder.summaries[-1]["cycles_copift"] += 1
        res = sess.reconcile(rep)
        assert not res["ok"]
        assert res == jsess.reconcile(jrep)

    def test_chrome_trace_json_valid(self, tmp_path):
        (sess, _), (jsess, _) = _both(
            lambda a: a.evaluate("expf", a.Target.homogeneous(n_cores=2)))
        path = tmp_path / "trace.perfetto.json"
        assert sess.save(path) == str(path)
        jsess.save(tmp_path / "jax.json")
        doc = json.loads(path.read_text())
        jdoc = json.loads((tmp_path / "jax.json").read_text())
        assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
        assert {e["ph"] for e in doc["traceEvents"]} <= {"X", "M"}
        for e in doc["traceEvents"]:
            if e["ph"] == "X":
                assert e["dur"] >= 0 and "ts" in e and "name" in e
        assert "api.evaluate" in {e["name"] for e in doc["traceEvents"]}
        assert doc["otherData"]["summaries"]
        assert _trace_parts(doc) == _trace_parts(jdoc)
        # the session's metrics ride along: the same names, and the same
        # values but the wall-clock spans'
        m, jm = doc["otherData"]["metrics"], jdoc["otherData"]["metrics"]
        assert sorted(m) == sorted(jm)
        assert {k: v for k, v in m.items() if not k.startswith("span.")} \
            == {k: v for k, v in jm.items() if not k.startswith("span.")}

    def test_sweep_traced_parity(self):
        targets = lambda a: [a.Target.homogeneous(n_cores=n)  # noqa: E731
                             for n in (1, 8)]
        memo.clear_all()
        untraced = api.sweep("logf", targets(api))
        (sess, traced), (jsess, jtraced) = _both(
            lambda a: a.sweep("logf", targets(a)))
        assert traced == untraced
        assert plain(traced) == plain(jtraced)
        assert [s["kind"] for s in sess.recorder.summaries] == \
            ["evaluate", "evaluate"]
        for rep, jrep in zip(traced, jtraced):
            assert sess.reconcile(rep) == jsess.reconcile(jrep)
            assert sess.reconcile(rep)["ok"]

    def test_system_target_records_spans_not_summaries(self):
        """A system target prices through ``system.evaluate`` inside the
        session: the same span and metrics as the JAX package, and no
        per-core summary (the system path records none in either)."""
        (sess, rep), (jsess, jrep) = _both(
            lambda a: a.evaluate("expf", a.Target.system(2)))
        assert plain(rep) == plain(jrep)
        assert _recorded(sess.recorder) == _recorded(jsess.recorder)
        assert [sp[:2] for sp in _recorded(sess.recorder)["spans"]] == \
            [("system.evaluate", 1)]
        assert not sess.recorder.summaries
        m, jm = sess.metrics(), jsess.metrics()
        assert m["system.evaluate.n_clusters"]["value"] == 2
        assert {k: v for k, v in m.items() if not k.startswith("span.")} \
            == {k: v for k, v in jm.items() if not k.startswith("span.")}


# ---------------------------------------------------------------------------
# 3. Metrics through a session
# ---------------------------------------------------------------------------

class TestSessionMetrics:
    def test_stall_breakdown_identity(self):
        def run(a):
            k = kernels_isa if a is api else jkisa
            t = timing if a is api else jtiming
            t.copift_block_timing(k.copift_schedule("expf"), 64)
        (sess, _), (jsess, _) = _both(run, trace=False, metrics=True)
        m = sess.metrics()
        assert m["timing.issue.cycles"]["value"] == \
            m["timing.issue.instructions"]["value"] \
            + m["timing.stall.raw_cycles"]["value"] \
            + m["timing.stall.wb_port_cycles"]["value"]
        assert m["timing.mem.accesses"]["value"] > 0
        assert m == jsess.metrics()

    def test_cluster_metrics_flow(self):
        (sess, _), (jsess, _) = _both(
            lambda a: a.evaluate("expf", a.Target.homogeneous(n_cores=8)),
            trace=False, metrics=True)
        m = sess.metrics()
        assert m["cluster.contention.stalls_per_access"]["count"] > 0
        assert m["cluster.dma.transfers"]["value"] >= 1
        assert m["cluster.dma.bytes"]["value"] > 0
        assert 0.0 <= m["perf.memo.timing.hit_rate"]["value"] <= 1.0
        jm = jsess.metrics()
        assert sorted(m) == sorted(jm)
        assert {k: v for k, v in m.items() if k.startswith("perf.memo.")} \
            == {k: v for k, v in jm.items() if k.startswith("perf.memo.")}

    def test_tune_and_oracle_metrics(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
        from repro_torch.tune.search import tune
        with obs.session(trace=False, metrics=True) as sess:
            tune("softmax", cache=False)
        m = sess.metrics()
        assert m["tune.oracle.batches"]["value"] >= 1
        assert m["tune.oracle.candidates"]["value"] > 0
        assert "span.tune.search.seconds" in m
        assert "span.tune.evaluate_batch.seconds" in m

    def test_metrics_isolated_between_sessions(self):
        with obs.session(trace=False, metrics=True) as s1:
            obs.metrics.inc("test.counter", 3)
        with obs.session(trace=False, metrics=True) as s2:
            pass
        assert s1.metrics().get("test.counter", {}).get("value") == 3
        assert "test.counter" not in s2.metrics()
        with obs.session(trace=False, metrics=False) as s3:
            obs.metrics.inc("test.counter")
        assert s3.metrics() == {}

    def test_trace_false_session_refuses_trace_views(self):
        with obs.session(trace=False) as sess:
            pass
        for view in (sess.trace_dict, sess.timeline, sess.reconcile):
            with pytest.raises(ValueError, match="trace=False"):
                view()


# ---------------------------------------------------------------------------
# 4. Spans and the recorder
# ---------------------------------------------------------------------------

class TestSpansAndRecorder:
    def test_nesting_and_provenance(self):
        def run(a):
            with (obs if a is api else jobs).span("outer", label="x"):
                a.evaluate("expf", a.Target.single_pe())
        (sess, _), (jsess, _) = _both(run)
        spans = {s["name"]: s for s in sess.recorder.spans}
        assert spans["outer"]["depth"] == 1
        assert spans["api.evaluate"]["depth"] == 2
        assert spans["api.evaluate"]["memo_provenance"] in ("cold", "mixed")
        assert _recorded(sess.recorder)["spans"] == \
            _recorded(jsess.recorder)["spans"]
        with obs.session() as sess2:
            api.evaluate("expf", api.Target.single_pe())
        sp = [s for s in sess2.recorder.spans if s["name"] == "api.evaluate"]
        assert sp[0]["memo_provenance"] == "hit"

    def test_span_noop_without_session(self):
        with obs.span("free") as handle:
            assert handle is None

    def test_event_caps_and_dropped_counter(self):
        def run(a):
            i = isa if a is api else jisa
            t = timing if a is api else jtiming
            body = [i.Instr("add", "r0", ("r1",)),
                    i.Instr("mul", "r2", ("r0",))]
            for _ in range(40):
                t.simulate_single_issue(body, 8)
        (sess, _), (jsess, _) = _both(run, max_events_per_stream=4,
                                      max_events=16)
        rec = sess.recorder
        assert len(rec.events) <= 16 and rec.dropped_events > 0
        tot = sum(v.get("busy", 0) for v in rec.lane_micro.values())
        assert tot > len(rec.events)
        assert _recorded(rec) == _recorded(jsess.recorder)

    def test_timeline_renders_as_the_jax_package(self):
        (sess, _), (jsess, _) = _both(
            lambda a: a.evaluate("expf", a.Target.single_pe()))
        text, jtext = sess.timeline(width=72), jsess.timeline(width=72)
        assert "rv32g" in text and "fpss" in text and "api.evaluate" in text
        # the lanes are identical; the span lines carry wall-clock ms
        assert text.split("spans:")[0] == jtext.split("spans:")[0]

    def test_hooks_bypassed_disables_everything(self):
        from repro_torch.obs import record
        with obs.session() as sess:
            with record.hooks_bypassed():
                assert record.active_recorder() is None
                assert not obs.metrics.enabled()
                timing.simulate_single_issue(
                    [isa.Instr("add", "r0", ("r1",))], 4)
            assert record.active_recorder() is sess.recorder
        assert sess.recorder.events == []


# ---------------------------------------------------------------------------
# 5. The trace CLI (python -m repro_torch.obs.trace)
# ---------------------------------------------------------------------------

def _cli_json(main, argv, capsys) -> tuple[int, dict]:
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


class TestTraceCli:
    def test_simulatable_kernel(self, tmp_path, capsys):
        from repro_torch.obs.trace import main
        out = tmp_path / "t.json"
        assert main(["expf", "--cores", "2", "--out", str(out)]) == 0
        assert "reconcile: ok=True" in capsys.readouterr().out
        assert json.loads(out.read_text())["traceEvents"]

    def test_tuner_only_kernel(self, tmp_path, capsys):
        from repro_torch.obs.trace import main
        out = tmp_path / "t.json"
        assert main(["softmax", "--out", str(out)]) == 0
        assert "tuner-only" in capsys.readouterr().out
        assert json.loads(out.read_text())["traceEvents"]

    def test_unknown_kernel_errors(self):
        from repro_torch.obs.trace import main
        with pytest.raises(SystemExit):
            main(["nosuchkernel"])

    @pytest.mark.parametrize("argv", [["expf", "--cores", "2"],
                                      ["softmax"],
                                      ["logf", "--cores", "3",
                                       "--blocks-per-core", "2"]],
                             ids=["expf", "softmax", "logf"])
    def test_json_output_equals_the_jax_package(self, argv, tmp_path,
                                                capsys):
        """--json prints the same machine-readable document as the JAX
        package's CLI (from cleared memos), and --out still writes the
        Perfetto trace beside it."""
        from repro.obs.trace import main as jmain
        from repro_torch.obs.trace import main
        out = tmp_path / "t.json"
        _clear_memos()
        rc, doc = _cli_json(main, argv + ["--json", "--out", str(out)],
                            capsys)
        jrc, jdoc = _cli_json(jmain, argv + ["--json"], capsys)
        assert rc == jrc == 0
        assert doc == jdoc
        assert doc["schema"] == 1 and doc["kernel"] == argv[0]
        if doc["simulatable"]:
            assert doc["reconcile"]["ok"]
            assert doc["result"]["speedup"] > 1
        else:
            assert doc["reconcile"] is None and doc["result"]["cycles"] > 0
        assert doc["lane_micro"] and doc["n_summaries"] >= doc["simulatable"]
        assert json.loads(out.read_text())["traceEvents"]

    def test_trace_kernel_equals_the_jax_package(self):
        from repro.obs.trace import trace_kernel as jtrace_kernel
        from repro_torch.obs.trace import trace_kernel
        _clear_memos()
        sess, rep, checks = trace_kernel("expf", n_cores=8)
        jsess, jrep, jchecks = jtrace_kernel("expf", n_cores=8)
        assert checks["ok"] and len(checks["checks"]) == 60
        assert checks == jchecks
        assert plain(rep) == plain(jrep)
        assert _recorded(sess.recorder) == _recorded(jsess.recorder)

    def test_module_cli_in_a_fresh_process(self, tmp_path):
        """``python -m repro_torch.obs.trace expf --cores 8 --json`` in a
        fresh process prints the JAX package's document: reconcile ok with
        60 per-lane checks, and the same events (34,420 from cold memos;
        how many a trace records depends on the memos' warmth, equally in
        both packages)."""
        import os
        import subprocess
        import sys
        from pathlib import Path
        src = Path(__file__).resolve().parent.parent / "src"
        out = tmp_path / "t.json"
        docs = []
        for pkg, extra in (("repro_torch", ["--out", str(out)]),
                           ("repro", [])):
            proc = subprocess.run(
                [sys.executable, "-m", f"{pkg}.obs.trace", "expf",
                 "--cores", "8", "--json"] + extra,
                env=dict(os.environ, PYTHONPATH=str(src)),
                capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stderr
            docs.append(json.loads(proc.stdout))
        doc, jdoc = docs
        assert doc == jdoc
        assert doc["reconcile"] == {"ok": True, "n_checks": 60}
        assert doc["n_events"] == 34420
        assert doc["result"]["speedup"] == 2.1197842747658244
        assert json.loads(out.read_text())["traceEvents"]


# ---------------------------------------------------------------------------
# 6. The serve engine's instrumentation
# ---------------------------------------------------------------------------

class TestServeEngine:
    def test_power_cap_without_autotune_names_both_fixes(self):
        from repro_torch.serve.engine import ServeEngine
        with pytest.raises(ValueError, match="autotune=True") as ei:
            ServeEngine(object(), None, power_cap_mw=5.0, device="cpu")
        assert "drop power_cap_mw" in str(ei.value)

    def test_autotune_records_plan_and_system_metrics(self, tmp_path,
                                                      monkeypatch):
        """The plan gauges, and with ``system=`` the
        ``serve.plan.system.*`` gauges, equal the JAX engine's."""
        monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
        monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "j.json"))
        from repro.kernels import ops as jops
        from repro.serve.engine import ServeEngine as JaxServeEngine
        from repro_torch.kernels import ops
        from repro_torch.serve.engine import ServeEngine
        kw = dict(autotune=True, power_cap_mw=1000.0)
        with obs.session(trace=True, metrics=True) as sess:
            with ServeEngine(object(), None, device="cpu",
                             system=api.parse_system("4x8c"), **kw) as eng:
                pass
        try:
            with jobs.session(trace=True, metrics=True) as jsess:
                JaxServeEngine(object(), None,
                               system=japi.parse_system("4x8c"), **kw)
        finally:
            jops.set_tuned_defaults(False)
        assert ops.tuned_defaults_enabled() is False
        m, jm = sess.metrics(), jsess.metrics()
        assert m["serve.autotune.wall_s"]["value"] > 0
        for name in ("softmax", "prng"):
            res = eng.operating_plan[name]
            assert m[f"serve.plan.{name}.cycles"]["value"] == \
                res.best_cost.cycles
            sp = eng.system_plan[name]
            assert m[f"serve.plan.system.{name}.n_clusters"]["value"] == \
                sp.n_clusters == 1
            for k in ("power_mw", "time_ns"):
                assert m[f"serve.plan.system.{name}.{k}"]["value"] == \
                    getattr(sp.best_cost, k)
        plan_keys = sorted(k for k in m if k.startswith("serve.plan."))
        assert plan_keys == sorted(k for k in jm
                                   if k.startswith("serve.plan."))
        assert {k: m[k] for k in plan_keys} == {k: jm[k] for k in plan_keys}
        assert "span.serve.autotune.seconds" in m
        spans = [(e["name"]) for e in sess.trace_dict()["traceEvents"]
                 if e.get("cat") == "span"]
        assert "serve.autotune" in spans and "system.select_point" in spans


# ---------------------------------------------------------------------------
# 7. Export edge cases
# ---------------------------------------------------------------------------

class TestExportEdgeCases:
    def test_chrome_trace_pinned_key_set(self):
        with obs.session(metrics=True) as sess:
            api.evaluate("expf", api.Target.homogeneous(n_cores=2))
        doc = obs.chrome_trace(sess.recorder)
        assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
        assert set(doc["otherData"]) == {
            "memo_provenance", "dropped_events", "lane_micro",
            "block_records", "summaries"}
        with_metrics = obs.chrome_trace(sess.recorder,
                                        metrics_snapshot={"g": 1.0})
        assert set(with_metrics["otherData"]) == {
            "memo_provenance", "dropped_events", "lane_micro",
            "block_records", "summaries", "metrics"}
        json.dumps(doc)

    def test_save_chrome_trace_writes_the_document(self, tmp_path):
        with obs.session() as sess:
            api.evaluate("expf", api.Target.single_pe())
        path = obs.save_chrome_trace(sess.recorder, tmp_path / "t.json",
                                     metrics_snapshot={"g": 1.0})
        doc = json.loads(open(path).read())
        assert doc["otherData"]["metrics"] == {"g": 1.0}
        assert _trace_parts(doc) == _trace_parts(
            json.loads(json.dumps(obs.chrome_trace(sess.recorder))))

    @pytest.mark.parametrize("width", [1, 2, 3, 7])
    def test_render_timeline_tiny_widths(self, width):
        (sess, _), (jsess, _) = _both(
            lambda a: a.evaluate("expf", a.Target.homogeneous(n_cores=2)))
        text = obs.render_timeline(sess.recorder, width=width)
        for lane_bit in ("int", "fpss", "rv32g"):
            assert lane_bit in text
        assert [ln for ln in text.splitlines() if "|" in ln]
        assert text.split("spans:")[0] == jobs.render_timeline(
            jsess.recorder, width=width).split("spans:")[0]

    def test_render_timeline_empty_recorder(self):
        assert obs.render_timeline(obs.TraceRecorder()) == \
            "(no lanes recorded)"

    def test_reconcile_empty_trace(self):
        rec = obs.TraceRecorder()
        res = obs.reconcile(rec)
        assert not res["ok"] and res["summaries"] == 0
        assert res["checks"][0]["name"] == "summary_present"
        assert res == jobs.reconcile(jobs.TraceRecorder())
        res2 = obs.reconcile(obs.chrome_trace(rec))
        assert not res2["ok"] and res2["summaries"] == 0
        with pytest.raises(TypeError, match="cannot extract summaries"):
            obs.reconcile(object())

    def test_reconcile_exact_despite_dropped_events(self):
        (sess, rep), (jsess, jrep) = _both(
            lambda a: a.evaluate("expf", a.Target.homogeneous(n_cores=8)),
            max_events_per_stream=8, max_events=64)
        assert sess.recorder.dropped_events > 0
        res = sess.reconcile(rep)
        assert res["ok"], [c for c in res["checks"] if not c["ok"]]
        assert res == jsess.reconcile(jrep)
        assert "dropped" in obs.render_timeline(sess.recorder)


# ---------------------------------------------------------------------------
# 8. Plan-transformed evaluate: traced parity + serial combine
# ---------------------------------------------------------------------------

class TestEvaluatePlanTraced:
    def test_default_plan_matches_plain_evaluate(self):
        from repro_torch.tune import default_space, get_workload
        default = default_space(get_workload("expf")).default
        target = api.Target.homogeneous(n_cores=4)
        memo.clear_all()
        untraced = api.evaluate("expf", target)
        with obs.session() as sess:
            planned = api.evaluate("expf", target, plan=default)
        assert planned == untraced
        assert sess.reconcile(planned)["ok"]

    def test_serial_plan_reconciles_with_sum_combine(self):
        from dataclasses import replace

        from repro import tune as jtune
        from repro_torch import tune

        def run(a):
            t = tune if a is api else jtune
            serial = replace(t.default_space(t.get_workload("logf")).default,
                             pipelined=False)
            return a.evaluate("logf", a.Target.homogeneous(n_cores=2),
                              plan=serial)
        (sess, rep), (jsess, jrep) = _both(run)
        s = sess.recorder.summaries[-1]
        assert all(c["combine"] == "sum" for c in s["cores"])
        res = sess.reconcile(rep)
        assert res["ok"], [c for c in res["checks"] if not c["ok"]]
        assert any(c["name"].startswith("serial_phase_sum")
                   for c in res["checks"])
        assert res == jsess.reconcile(jrep)
        assert _recorded(sess.recorder) == _recorded(jsess.recorder)
        with obs.session():
            piped = api.evaluate("logf", api.Target.homogeneous(n_cores=2))
        assert rep.cycles_copift >= piped.cycles_copift

    def test_island_plans_rejected(self):
        from dataclasses import replace

        from repro_torch.tune import default_space, get_workload
        cand = replace(default_space(get_workload("expf")).default,
                       islands=(("1.00GHz", 4),))
        with pytest.raises(ValueError, match="island"):
            api.evaluate("expf", api.Target.homogeneous(n_cores=4),
                         plan=cand)
