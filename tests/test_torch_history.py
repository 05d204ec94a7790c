"""The port's metric history (``repro_torch.obs.history``) and HTML report
(``repro_torch.obs.report``) against the JAX package's, on the CPU.

The same records go into each package's store (each its own file under
``tmp_path``) and every read-back, flattened snapshot, direction,
regression document, formatted line, CLI output and exit code must equal
the JAX package's with ``==``; the HTML report must be byte-equal given
the same recorder, attribution, history and title.  Mirrors
``tests/test_history.py`` but its benchmark-writer cases (``benchmarks/``
is not ported).  The port's store is its own: ``$REPRO_TORCH_METRIC_HISTORY``,
else ``BENCH_history_torch.jsonl``."""

import json
import warnings

import pytest

pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.obs import history as jhistory  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.perf import memo as jmemo  # noqa: E402
from repro_torch import api, obs  # noqa: E402
from repro_torch.obs import history, report  # noqa: E402
from repro_torch.perf import memo  # noqa: E402

BOTH = (history, jhistory)


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    """Both packages' tune caches (the report's attribution tunes) under
    ``tmp_path``."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))


def _append_run(H, path, speedup, cycles=1000.0, seconds=1.0, ts=0.0,
                source="bench"):
    return H.append_record(
        {"tune/expf/speedup": speedup, "fig2/expf/cycles": cycles,
         "perf/oracle/batch_seconds": seconds},
        source=source, path=path, sha="deadbeef", ts=ts)


def _stores(tmp_path, runs) -> list[str]:
    """One store per package, each holding ``runs``: a list of keyword
    dicts for :func:`_append_run` (or of ``(metrics, kw)`` pairs for
    ``append_record``)."""
    paths = []
    for H in BOTH:
        p = tmp_path / f"{H.__name__.split('.')[0]}.jsonl"
        for run in runs:
            if isinstance(run, tuple):
                H.append_record(run[0], path=p, **run[1])
            else:
                _append_run(H, p, **run)
        paths.append(p)
    return paths


def _detect(tmp_path, runs, **kw) -> dict:
    """``detect_regressions`` over ``runs`` in each package; asserts the two
    documents equal and returns the port's."""
    p, jp = _stores(tmp_path, runs)
    doc = history.detect_regressions(path=p, **kw)
    assert doc == jhistory.detect_regressions(path=jp, **kw)
    return doc


class TestStore:
    def test_append_read_roundtrip(self, tmp_path):
        recs = [H.append_record({"a/b": 1.5, "c/d": 2}, source="s",
                                path=tmp_path / f"{i}.jsonl", sha="abc",
                                ts=42.0)
                for i, H in enumerate(BOTH)]
        assert recs[0] == recs[1]
        assert recs[0]["schema"] == history.SCHEMA == jhistory.SCHEMA
        assert recs[0]["metrics"] == {"a/b": 1.5, "c/d": 2.0}
        assert history.read_history(tmp_path / "0.jsonl") == [recs[0]]
        assert history.read_history.skipped == 0
        assert (tmp_path / "0.jsonl").read_text() == \
            (tmp_path / "1.jsonl").read_text()

    def test_append_is_append_only(self, tmp_path):
        p, _ = _stores(tmp_path, [dict(speedup=1.5, ts=float(i))
                                  for i in range(3)])
        assert [r["ts"] for r in history.read_history(p)] == [0.0, 1.0, 2.0]

    def test_corrupt_and_truncated_lines_skipped(self, tmp_path):
        for H in BOTH:
            p = tmp_path / f"{H.__name__}.jsonl"
            _append_run(H, p, 1.5, ts=0.0)
            with open(p, "a") as f:
                f.write('{"truncated": \n')
                f.write("not json at all\n")
                f.write('{"no_metrics_key": 1}\n')
                f.write("\n")
            _append_run(H, p, 1.4, ts=1.0)
            assert len(H.read_history(p)) == 2
            assert H.read_history.skipped == 3

    def test_missing_file_is_empty_history(self, tmp_path):
        assert history.read_history(tmp_path / "nope.jsonl") == []

    def test_source_filter(self, tmp_path):
        p, jp = _stores(tmp_path, [dict(speedup=1.5, source="a"),
                                   dict(speedup=1.4, source="b")])
        assert history.read_history(p, source="a") == \
            jhistory.read_history(jp, source="a")
        assert len(history.read_history(p, source="a")) == 1

    def test_path_resolution_env_var(self, tmp_path, monkeypatch):
        """The port's own variable and default file, never the JAX
        package's."""
        monkeypatch.delenv(history.ENV_VAR, raising=False)
        monkeypatch.setenv(jhistory.ENV_VAR, str(tmp_path / "jax.jsonl"))
        assert history.ENV_VAR == "REPRO_TORCH_METRIC_HISTORY"
        assert history.DEFAULT_FILENAME == "BENCH_history_torch.jsonl"
        assert history.history_path("x.jsonl") == "x.jsonl"
        assert history.history_path() == history.DEFAULT_FILENAME
        monkeypatch.setenv(history.ENV_VAR, str(tmp_path / "env.jsonl"))
        assert history.history_path() == str(tmp_path / "env.jsonl")
        assert jhistory.history_path() == str(tmp_path / "jax.jsonl")


class TestFlattenSnapshot:
    @pytest.mark.parametrize("snap,want", [
        ({"schema": 1, "sections": {
            "fig2": {"lines": ["fig2.expf,speedup,1.50",
                               "fig2.expf,speedup,1.40",
                               "fig2.logf,ipc,0.9,1.1"]},
            "perf": {"lines": [], "error": "skipped"}}},
         {"fig2/fig2.expf,speedup/c2": 1.50,
          "fig2/fig2.expf,speedup@1/c2": 1.40,
          "fig2/fig2.logf,ipc/c2": 0.9, "fig2/fig2.logf,ipc/c3": 1.1}),
        ({"sections": {"tune": {"lines": [
            "tune.kernel,block,default_cycles,predicted_speedup",
            "tune.expf,157,744552,1.0003",
            "tune.softmax,136,746597,1.0018,9.9"]}}},
         {"tune/tune.expf/block": 157.0,
          "tune/tune.expf/default_cycles": 744552.0,
          "tune/tune.expf/predicted_speedup": 1.0003,
          "tune/tune.softmax/block": 136.0,
          "tune/tune.softmax/default_cycles": 746597.0,
          "tune/tune.softmax/predicted_speedup": 1.0018,
          "tune/tune.softmax/c4": 9.9}),
        ({"sections": {"s": {"lines": ["k,inf,nan,2.0"]}}}, {"s/k/c3": 2.0}),
        ({"sections": {"obs": {"lines": [
            "obs.overhead,mode,seconds,overhead_vs_reference",
            "obs.overhead,disabled,0.703,+29.5%"]}}},
         {"obs/obs.overhead,disabled/seconds": 0.703,
          "obs/obs.overhead,disabled/overhead_vs_reference": 29.5}),
    ], ids=["diff_identity", "header_names_columns", "non_finite_dropped",
            "percent_tokens_are_data"])
    def test_flatten(self, snap, want):
        assert history.flatten_snapshot(snap) == want == \
            jhistory.flatten_snapshot(snap)

    def test_append_snapshot_records_sections(self, tmp_path):
        snap = {"sections": {"fig2": {"lines": ["fig2.expf,speedup,1.5"]}}}
        rec = history.append_snapshot(snap, path=tmp_path / "h.jsonl")
        jrec = jhistory.append_snapshot(snap, path=tmp_path / "j.jsonl")
        assert rec["source"] == "benchmarks.run"
        assert rec["meta"]["sections"] == ["fig2"]
        assert {k: v for k, v in rec.items() if k not in ("ts", "sha")} == \
            {k: v for k, v in jrec.items() if k not in ("ts", "sha")}


class TestDirectionRules:
    def test_rules_are_the_jax_package(self):
        assert history.DIRECTION_RULES == jhistory.DIRECTION_RULES

    @pytest.mark.parametrize("name,want", [
        ("perf/oracle/batch_seconds", "advisory"),
        ("perf/oracle/candidates_per_sec", "advisory"),
        ("tune/measured_default_us/c3", "advisory"),
        ("obs_bench/disabled_overhead", "advisory"),
        ("tune/expf/speedup", "lower_worse"),
        ("fig2/expf/ipc", "lower_worse"),
        ("tune/point/saving_vs_nominal", "lower_worse"),
        ("fig2/expf/cycles", "higher_worse"),
        ("table1/expf/energy_uj", "higher_worse"),
        ("cluster/expf/power_mw", "higher_worse"),
        ("system/system.eff.compute.expf/c2", "lower_worse"),
        ("resilience/resilience.policy.static/lost", "higher_worse"),
        ("resilience/resilience.policy.failover(static+1)/completed_frac",
         "lower_worse"),
        ("something/else/entirely", "advisory"),
    ])
    def test_first_match_classification(self, name, want):
        assert history.metric_direction(name) == want == \
            jhistory.metric_direction(name)


class TestMemoryFallback:
    def _unwritable(self, tmp_path, tag):
        blocker = tmp_path / f"blocker_{tag}"
        blocker.write_text("not a directory")
        return str(blocker / "hist.jsonl")

    def test_append_warns_once_and_keeps_records(self, tmp_path):
        bad = self._unwritable(tmp_path, "torch")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            history.append_record({"m": 1.0}, source="t", path=bad, ts=1.0)
            history.append_record({"m": 2.0}, source="t", path=bad, ts=2.0)
        runtime = [w for w in caught
                   if issubclass(w.category, RuntimeWarning)]
        assert len(runtime) == 1
        assert "in-memory" in str(runtime[0].message)
        recs = history.read_history(bad, source="t")
        assert [r["metrics"]["m"] for r in recs] == [1.0, 2.0]
        assert bad not in jhistory._MEMORY

    def test_memory_records_feed_regression_detection(self, tmp_path):
        docs = []
        for H in BOTH:
            bad = self._unwritable(tmp_path, H.__name__)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for i, speedup in enumerate((2.0, 2.0, 2.0, 1.0)):
                    H.append_record({"tune/expf/speedup": speedup},
                                    source="t", path=bad, ts=float(i))
            docs.append(H.detect_regressions(path=bad))
        assert docs[0] == docs[1]
        assert not docs[0]["ok"]
        assert docs[0]["regressions"][0]["metric"] == "tune/expf/speedup"

    def test_writable_path_untouched_by_fallback(self, tmp_path):
        p = tmp_path / "hist.jsonl"
        history.append_record({"m": 1.0}, source="t", path=p, ts=1.0)
        assert str(p) not in history._MEMORY
        assert len(history.read_history(p)) == 1


class TestDetectRegressions:
    def test_needs_two_records(self, tmp_path):
        doc = _detect(tmp_path, [dict(speedup=1.5)])
        assert doc["ok"] and doc["checked"] == 0

    def test_hard_speedup_drop_fails(self, tmp_path):
        doc = _detect(tmp_path, [dict(speedup=1.5, ts=float(i))
                                 for i in range(4)]
                      + [dict(speedup=1.25, ts=9.0)])
        assert not doc["ok"]
        (r,) = [r for r in doc["regressions"] if r["severity"] == "hard"]
        assert (r["metric"], r["direction"]) == \
            ("tune/expf/speedup", "lower_worse")
        assert r["rel_delta"] == pytest.approx(-1 / 6)

    def test_soft_band_reports_without_gating(self, tmp_path):
        doc = _detect(tmp_path, [dict(speedup=1.5, ts=float(i))
                                 for i in range(4)]
                      + [dict(speedup=1.5, cycles=1040.0, ts=9.0)])
        assert doc["ok"]
        assert [r["severity"] for r in doc["regressions"]] == ["soft"]

    def test_advisory_metrics_never_gate(self, tmp_path):
        doc = _detect(tmp_path, [dict(speedup=1.5, ts=float(i))
                                 for i in range(4)]
                      + [dict(speedup=1.5, seconds=40.0, ts=9.0)])
        assert doc["ok"]
        assert [r["severity"] for r in doc["regressions"]] == ["info"]

    def test_improvements_counted_not_flagged(self, tmp_path):
        doc = _detect(tmp_path, [dict(speedup=1.5, ts=float(i))
                                 for i in range(4)]
                      + [dict(speedup=2.0, cycles=800.0, ts=9.0)])
        assert doc["ok"] and not doc["regressions"]
        assert doc["improvements"] == 2

    def test_median_baseline_resists_one_bad_run(self, tmp_path):
        doc = _detect(tmp_path, [dict(speedup=s, ts=float(i)) for i, s in
                                 enumerate((1.5, 1.5, 0.1, 1.5))]
                      + [dict(speedup=1.5, ts=9.0)])
        assert doc["ok"] and not doc["regressions"]

    def test_window_bounds_the_baseline(self, tmp_path):
        runs = [dict(speedup=3.0, ts=float(i)) for i in range(6)] + \
            [dict(speedup=1.5, ts=10.0 + i) for i in range(8)] + \
            [dict(speedup=1.5, ts=99.0)]
        doc = _detect(tmp_path, runs, window=8)
        assert doc["ok"] and not doc["regressions"]

    def test_sources_isolated(self, tmp_path):
        runs = [dict(speedup=1.5, ts=float(i), source="a") for i in range(3)]
        runs += [dict(speedup=99.0, ts=5.0, source="b"),
                 dict(speedup=1.5, ts=6.0, source="a")]
        doc = _detect(tmp_path, runs)
        assert doc["ok"] and doc["sources"] == {"a": 4, "b": 1}

    def test_new_metric_skipped_zero_baseline_inf(self, tmp_path):
        kw = dict(source="s")
        first = [({"x/cycles": 0.0}, dict(kw, ts=0.0)),
                 ({"x/cycles": 0.0, "y/cycles": 5.0}, dict(kw, ts=1.0))]
        for d in ("a", "b"):
            (tmp_path / d).mkdir()
        doc = _detect(tmp_path / "a", first)
        assert doc["ok"] and doc["checked"] == 1
        doc = _detect(tmp_path / "b",
                      first + [({"x/cycles": 1.0}, dict(kw, ts=2.0))])
        assert not doc["ok"]
        assert doc["regressions"][0]["rel_delta"] == float("inf")

    def test_threshold_validation(self):
        for H in BOTH:
            with pytest.raises(ValueError, match="soft"):
                H.detect_regressions([], soft=0.2, hard=0.1)

    def test_format_lines(self, tmp_path):
        p, jp = _stores(tmp_path, [dict(speedup=1.5, ts=float(i))
                                   for i in range(3)]
                        + [dict(speedup=1.0, ts=9.0)])
        lines = history.format_regressions(history.detect_regressions(path=p))
        assert lines == jhistory.format_regressions(
            jhistory.detect_regressions(path=jp))
        assert lines[0].startswith("history.checked,")
        assert any(ln.startswith("history.hard,") for ln in lines)


class TestCli:
    def _run(self, main, argv, capsys):
        try:
            main(argv)
            code = 0
        except SystemExit as e:
            code = e.code
        return code, capsys.readouterr().out

    def _both(self, tmp_path, runs, extra, capsys):
        p, jp = _stores(tmp_path, runs)
        code, out = self._run(history.main, ["--path", str(p)] + extra,
                              capsys)
        jcode, jout = self._run(jhistory.main, ["--path", str(jp)] + extra,
                                capsys)
        assert code == jcode
        assert out.replace(str(p), "STORE") == jout.replace(str(jp), "STORE")
        return code, out

    def test_check_exits_1_on_hard(self, tmp_path, capsys):
        code, out = self._both(tmp_path, [dict(speedup=1.5, ts=float(i))
                                          for i in range(3)]
                               + [dict(speedup=1.0, ts=9.0)], ["--check"],
                               capsys)
        assert code == 1 and "history.fail" in out

    def test_check_clean_exits_0(self, tmp_path, capsys):
        code, out = self._both(tmp_path, [dict(speedup=1.5, ts=float(i))
                                          for i in range(3)], ["--check"],
                               capsys)
        assert code == 0 and "history.clean" in out

    def test_store_summary(self, tmp_path, capsys):
        code, out = self._both(tmp_path, [dict(speedup=1.5)], [], capsys)
        assert "history.store," in out and "history.source,bench," in out

    def test_module_cli_check_exits_1(self, tmp_path):
        """``python -m repro_torch.obs.history --path P --check`` in a
        process of its own: exit 1 on a ``*cycles*`` metric raised 50 %."""
        import os
        import subprocess
        import sys
        from pathlib import Path
        p = tmp_path / "h.jsonl"
        for i in range(2):
            history.append_record({"fig2/expf/cycles": 1000.0}, source="s",
                                  path=p, sha="deadbeef", ts=float(i))
        history.append_record({"fig2/expf/cycles": 1500.0}, source="s",
                              path=p, sha="deadbeef", ts=2.0)
        src = Path(__file__).resolve().parent.parent / "src"
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.history", "--path",
             str(p), "--check"], env=dict(os.environ, PYTHONPATH=str(src)),
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "history.hard,s,fig2/expf/cycles,1000,1500,+50.00%" in \
            proc.stdout


# ---------------------------------------------------------------------------
# The HTML report
# ---------------------------------------------------------------------------

def _traced_pair():
    memo.clear_all()
    jmemo.clear_all()
    with obs.session() as sess:
        api.evaluate("expf", api.Target.homogeneous(n_cores=2))
    with jobs.session() as jsess:
        japi.evaluate("expf", japi.Target.homogeneous(n_cores=2))
    return sess, jsess


class TestHtmlReport:
    def test_save_report_self_contained_and_byte_equal(self, tmp_path):
        sess, jsess = _traced_pair()
        p, jp = _stores(tmp_path, [dict(speedup=s, ts=float(i)) for i, s in
                                   enumerate((1.5, 1.5, 1.5, 1.2))])
        att = api.Tuner(cache=False).attribute("softmax")
        jatt = japi.Tuner(cache=False).attribute("softmax")
        out = tmp_path / "r.html"
        assert report.save_report(out, trace=sess.recorder, history=p,
                                  attribution=att, title="t") == str(out)
        html = out.read_text()
        assert html.lstrip().lower().startswith("<!doctype html>")
        assert "<svg" in html and "Metric trends" in html
        assert "tune/expf/speedup" in html and "Attribution waterfall" in html
        assert "src=" not in html and "href=" not in html
        assert html == jreport.html_report(trace=jsess.recorder, history=jp,
                                           attribution=jatt, title="t")

    @pytest.mark.parametrize("what", ["trace", "attribution_dicts",
                                      "history_records", "empty"])
    def test_html_report_sections_byte_equal(self, what, tmp_path):
        sess, jsess = _traced_pair()
        kw, jkw = {}, {}
        if what == "trace":
            kw, jkw = dict(trace=sess), dict(trace=jsess)
        elif what == "attribution_dicts":
            att = api.Tuner(cache=False).attribute("prng").to_dict()
            jatt = japi.Tuner(cache=False).attribute("prng").to_dict()
            kw, jkw = dict(attribution=[att, att]), dict(
                attribution=[jatt, jatt])
        elif what == "history_records":
            p, jp = _stores(tmp_path, [dict(speedup=1.5, ts=float(i))
                                       for i in range(3)]
                            + [dict(speedup=1.0, cycles=2000.0, ts=9.0)])
            kw = dict(history=history.read_history(p))
            jkw = dict(history=jhistory.read_history(jp))
        html = report.html_report(title="x", window=4, **kw)
        assert html == jreport.html_report(title="x", window=4, **jkw)
        assert report.html_report(**kw).count("repro_torch observability")

    def test_report_cli_writes_and_exits_0(self, tmp_path, capsys):
        p, _ = _stores(tmp_path, [dict(speedup=1.5, ts=float(i))
                                  for i in range(2)])
        out = tmp_path / "r.html"
        assert report.main(["expf", "--cores", "2", "--history", str(p),
                            "--out", str(out)]) == 0
        assert out.stat().st_size > 10_000
        text = capsys.readouterr().out
        assert f"report.written,{out}" in text and "exact=True" in text

    def test_terminal_summary_sections(self, tmp_path):
        sess, jsess = _traced_pair()
        p, jp = _stores(tmp_path, [dict(speedup=1.5, ts=float(i))
                                   for i in range(2)])
        text = report.terminal_summary(trace=sess.recorder,
                                       history=history.read_history(p))
        jtext = jreport.terminal_summary(trace=jsess.recorder,
                                         history=jhistory.read_history(jp))
        assert "issue timeline" in text and "history.checked" in text
        assert text.split("spans:")[0] == jtext.split("spans:")[0]
        assert report.terminal_summary() == "(nothing to report)"
        att = json.loads(json.dumps(
            api.Tuner(cache=False).attribute("prng").to_dict()))
        assert report.terminal_summary(attribution=att) == \
            json.dumps(att, indent=1)
