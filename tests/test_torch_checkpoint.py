"""The port's checkpoints and fault handling on the CPU: ``save``/``load``
round trips bit-exact with no partial file under the final name,
``AsyncSaver`` snapshots its state at ``submit``, ``CheckpointManager``
retention, ``latest`` and ``restore_or_init``, ``elastic_restore``,
``StragglerMonitor`` against the JAX package's (the cases of
tests/test_train_infra.py), the metrics registry and trace recorder copies
against the JAX package's, resume through ``launch.train`` bit-equal to a
straight run, and ``launch.serve --params``."""

import contextvars
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import record as jrecord  # noqa: E402
from repro.train.fault import StragglerMonitor as JaxStragglerMonitor  # noqa: E402
from repro_torch.configs import load_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import record as trecord  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.fault import (CheckpointManager,  # noqa: E402
                                     StragglerMonitor, elastic_restore)
from repro_torch.train.train_step import init_train_state  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params/a.w": torch.randn(4, 3, generator=g),
            "params/b.g": torch.randn(7, generator=g),
            "opt/m/a.w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
            "opt/step": torch.tensor(12, dtype=torch.int32)}


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _smoke_state(seed=0):
    cfg = load_config("olmo-1b", "smoke")
    return init_train_state(cfg, init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu"))


class TestSaveLoad:
    def test_round_trip_bit_exact(self, tmp_path):
        path = str(tmp_path / "sub" / "c.pt")
        tree = _tree()
        ckpt.save(path, tree, {"step": 12, "note": "x"})
        got, meta = ckpt.load(path)
        _equal(got, tree)
        assert meta == {"step": 12, "note": "x"}
        assert os.listdir(tmp_path / "sub") == ["c.pt"]

    def test_train_state_round_trip(self, tmp_path):
        state = _smoke_state()
        ckpt.save(str(tmp_path / "s.pt"), state.state_dict())
        other = _smoke_state(seed=1)
        arrays, _ = ckpt.load(str(tmp_path / "s.pt"))
        other.load_state_dict(arrays)
        _equal(other.state_dict(), state.state_dict())

    def test_failed_write_leaves_no_file_under_the_final_name(
            self, tmp_path, monkeypatch):
        path = str(tmp_path / "c.pt")
        ckpt.save(path, _tree(0))

        def boom(obj, f):
            f.write(b"partial")
            raise OSError("disk full")
        monkeypatch.setattr(ckpt.torch, "save", boom)
        with pytest.raises(OSError, match="disk full"):
            ckpt.save(path, _tree(1))
        got, _ = ckpt.load(path)                  # the old file, intact
        _equal(got, _tree(0))

    def test_loaded_tensors_lie_on_the_cpu(self, tmp_path):
        path = str(tmp_path / "c.pt")
        ckpt.save(path, {"x": torch.ones(2)})
        got, _ = ckpt.load(path)
        assert got["x"].device.type == "cpu"

    def test_load_state_dict_checks_keys_and_shapes(self):
        state = _smoke_state()
        arrays = {k: v.clone() for k, v in state.state_dict().items()}
        with pytest.raises(KeyError, match="missing"):
            state.load_state_dict({k: v for k, v in arrays.items()
                                   if k != "opt/step"})
        arrays["opt/step"] = torch.tensor(1, dtype=torch.int64)
        with pytest.raises(ValueError, match="opt/step"):
            state.load_state_dict(arrays)


class TestAsyncSaver:
    def test_submit_snapshots_the_state(self, tmp_path):
        """Updates in place right after ``submit`` must not reach the file
        (``.cpu()`` of a CPU tensor is the tensor itself)."""
        tree = _tree()
        want = {k: v.clone() for k, v in tree.items()}
        saver = ckpt.AsyncSaver()
        saver.submit(str(tmp_path / "c.pt"), tree, {"step": 1})
        for v in tree.values():
            v.add_(1)
        saver.wait()
        got, meta = ckpt.load(str(tmp_path / "c.pt"))
        _equal(got, want)
        assert meta == {"step": 1}

    def test_error_surfaces_on_wait(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        saver = ckpt.AsyncSaver()
        saver.submit(str(blocker / "c.pt"), _tree())
        with pytest.raises(OSError):
            saver.wait()
        saver.wait()                               # raised once


class TestManager:
    @pytest.mark.parametrize("async_save", [True, False])
    def test_retention_and_latest(self, tmp_path, async_save):
        m = CheckpointManager(str(tmp_path), keep=2, async_save=async_save)
        assert m.latest() is None and m.all_steps() == []
        for step in (1, 2, 3, 10, 20):
            m.save(step, _tree(step))
        m.wait()
        m._gc()                       # the last async write lands after gc
        assert m.all_steps() == [10, 20] and m.latest() == 20
        got, meta = m.restore(20)
        _equal(got, _tree(20))
        assert meta["step"] == 20 and "time" in meta
        assert sorted(os.listdir(tmp_path)) == ["step_00000010.pt",
                                                "step_00000020.pt"]

    def test_restore_or_init(self, tmp_path):
        m = CheckpointManager(str(tmp_path), async_save=False)
        state, step = m.restore_or_init(lambda: _smoke_state(0))
        assert step == 0
        state.opt["step"].fill_(7)
        m.save(7, state.state_dict())
        again, step = m.restore_or_init(lambda: _smoke_state(1))
        assert step == 7
        _equal(again.state_dict(), state.state_dict())

    def test_elastic_restore(self, tmp_path):
        m = CheckpointManager(str(tmp_path), async_save=False)
        with pytest.raises(FileNotFoundError):
            elastic_restore(m, lambda d: _smoke_state(), "cpu")
        state = _smoke_state(2)
        m.save(3, state.state_dict())
        got, step = elastic_restore(m, lambda d: _smoke_state(0), "cpu")
        assert step == 3
        _equal(got.state_dict(), state.state_dict())
        # Onto a mesh: the rule table places the restored state there (a
        # world of one process here; tests/test_torch_collectives.py
        # restores a (2, 2) state onto (2,) in four).
        with pytest.raises(ValueError, match="needs the model config"):
            elastic_restore(m, lambda d: _smoke_state(), "cpu",
                            mesh=object())
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch.launch.mesh import make_mesh
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), "cpu")
            got, step = elastic_restore(m, lambda d: _smoke_state(0), "cpu",
                                        mesh=mesh,
                                        cfg=load_config("olmo-1b", "smoke"))
            assert step == 3
            sd = got.state_dict()
            assert all(isinstance(v, DTensor) and v.device_mesh is mesh
                       and v.placements == (Replicate(), Replicate())
                       for v in sd.values())
            _equal({k: v.full_tensor() for k, v in sd.items()},
                   state.state_dict())
        finally:
            dist.destroy_process_group()


def _both_monitors(script):
    """Run ``script(monitor)`` on the port's and the JAX package's."""
    t, j = StragglerMonitor(), JaxStragglerMonitor()
    out = script(t), script(j)
    assert t.events == j.events and t.history == j.history
    return t, out


class TestStraggler:
    def test_detects_slow_host(self):
        def script(mon):
            flagged = []
            for step in range(20):
                for host in ("h0", "h1", "h2", "h3"):
                    dt = 1.0 + (0.02 * step % 0.05)
                    if host == "h3" and step > 10:
                        dt = 3.0
                    if mon.record(host, step, dt):
                        flagged.append((host, step))
            return flagged
        _, (flagged, jflagged) = _both_monitors(script)
        assert flagged == jflagged and {h for h, _ in flagged} == {"h3"}

    def test_rebalance_moves_work(self):
        def script(mon):
            for step in range(12):
                mon.record("h0", step, 1.0)
                mon.record("h1", step, 1.02)
                mon.record("h2", step, 4.0 if step > 8 else 1.0)
            return mon.rebalance_plan({"h0": 4, "h1": 4, "h2": 4})
        _, (plan, jplan) = _both_monitors(script)
        assert plan == jplan and plan["h2"] < 4 and sum(plan.values()) == 12

    def test_no_false_positives_on_uniform(self):
        def script(mon):
            rng = np.random.default_rng(0)
            for step in range(30):
                for host in ("a", "b"):
                    mon.record(host, step, 1.0 + 0.01 * rng.random())
        mon, _ = _both_monitors(script)
        assert not mon.events

    def test_single_host_uses_its_own_history(self):
        def script(mon):
            return [mon.record("h0", s, 5.0 if s == 12 else 1.0 + 0.01 * s)
                    for s in range(14)]
        _, (got, want) = _both_monitors(script)
        assert got == want and got[12] and not any(got[:12])

    def test_detections_land_in_obs_metrics(self):
        mon = StragglerMonitor()

        def run():
            tmetrics.set_enabled(True)
            for step in range(16):
                for host in ("h0", "h1", "h2", "h3"):
                    dt = 5.0 if host == "h3" and step > 10 else 1.0
                    mon.record(host, step, dt)
            return tmetrics.REGISTRY.snapshot()
        tmetrics.REGISTRY.reset()
        try:
            m = contextvars.copy_context().run(run)
        finally:
            tmetrics.REGISTRY.reset()
        assert m["train.straggler.detected"]["value"] == len(mon.events) > 0
        assert m["train.straggler.step_seconds.h3"]["value"] == 5.0
        assert m["train.straggler.step_seconds.h0"]["value"] == 1.0
        assert m["train.straggler.last_z.h3"]["value"] > 3.5
        assert not tmetrics.enabled()              # the scope ended

    def test_metrics_disabled_is_no_op(self):
        before = tmetrics.REGISTRY.snapshot()
        mon = StragglerMonitor()
        for step in range(16):
            for host in ("h0", "h1", "h2", "h3"):
                dt = 5.0 if host == "h3" and step > 10 else 1.0
                mon.record(host, step, dt)
        assert mon.events
        assert tmetrics.REGISTRY.snapshot() == before


class TestObsCopies:
    def test_registry_matches_jax(self):
        def feed(mod):
            reg = mod.Registry()
            reg.counter("c").inc()
            reg.counter("c").inc(2.5)
            reg.gauge("g").set(4)
            for v in (3.0, 1.0, 8.0):
                reg.histogram("h").observe(v)
            with pytest.raises(TypeError, match="already registered"):
                reg.gauge("c")
            return reg.snapshot(), reg.value("h"), reg.value("nope", -1)
        assert feed(tmetrics) == feed(jmetrics)

    def test_hooks_bypassed_silences_metrics(self):
        def run():
            tmetrics.set_enabled(True)
            assert tmetrics.enabled()
            with trecord.hooks_bypassed():
                assert not tmetrics.enabled()
            return tmetrics.enabled()
        assert contextvars.copy_context().run(run)

    def test_recorder_matches_jax(self):
        def feed(mod):
            rec = mod.TraceRecorder(max_events=6, max_events_per_stream=3)
            with mod.recording(rec):
                assert mod.active_recorder() is rec
                with rec.lane("core0"), rec.lane("int"), rec.repeat(4):
                    rec.stream(10, 4, {"raw": 2}, [(1, "add", 0, None),
                                                   (3, "mul", 1, "raw"),
                                                   (5, "lw", 0, None),
                                                   (6, "sw", 0, None)],
                               "cold")
                    rec.annotate("block_overhead", 3)
                    rec.block_record(kind="copift", block=8)
                rec.summary({"cycles": 43})
            assert mod.active_recorder() is None
            return (rec.events, rec.dropped_events, rec.lane_micro,
                    rec.memo_provenance, rec.block_records, rec.summaries,
                    rec._cursor)
        assert feed(trecord) == feed(jrecord)


def _join_savers(timeout=60):
    for t in threading.enumerate():
        if t is not threading.current_thread() and t.daemon:
            t.join(timeout)


class TestResume:
    def test_three_plus_three_equals_six(self, tmp_path, monkeypatch):
        """A 6-step run that dies after its step-3 checkpoint, resumed,
        ends bit-equal to a straight 6-step run: masters, moments, step."""
        base = ["--device", "cpu", "--steps", "6", "--batch", "2", "--seq",
                "16", "--ckpt-every", "3", "--lr", "1e-2"]
        straight = launch_train.main(base + ["--ckpt-dir",
                                             str(tmp_path / "a")])
        real = launch_train.make_train_step

        def dies_after_three(*a, **kw):
            fn, calls = real(*a, **kw), []

            def step(state, batch):
                if len(calls) == 3:
                    raise KeyboardInterrupt("killed")
                calls.append(1)
                return fn(state, batch)
            return step
        monkeypatch.setattr(launch_train, "make_train_step", dies_after_three)
        with pytest.raises(KeyboardInterrupt):
            launch_train.main(base + ["--ckpt-dir", str(tmp_path / "b")])
        _join_savers()
        assert sorted(os.listdir(tmp_path / "b")) == ["step_00000003.pt"]
        monkeypatch.setattr(launch_train, "make_train_step", real)
        resumed = launch_train.main(base + ["--ckpt-dir",
                                            str(tmp_path / "b")])
        assert [h["step"] for h in resumed] == [3, 4, 5]
        assert [h["loss"] for h in resumed] == \
            [h["loss"] for h in straight[3:]]
        a, _ = ckpt.load(str(tmp_path / "a" / "step_00000006.pt"))
        b, _ = ckpt.load(str(tmp_path / "b" / "step_00000006.pt"))
        _equal(a, b)
        assert int(b["opt/step"]) == 6

    def test_resume_prints_the_step(self, tmp_path, capsys):
        argv = ["--device", "cpu", "--batch", "2", "--seq", "8",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
        launch_train.main(argv + ["--steps", "2"])
        capsys.readouterr()
        hist = launch_train.main(argv + ["--steps", "4"])
        assert "[resume] from step 2" in capsys.readouterr().out
        assert [h["step"] for h in hist] == [2, 3]
        assert sorted(os.listdir(tmp_path)) == ["step_00000002.pt",
                                                "step_00000004.pt"]


def test_serve_from_a_checkpoint(tmp_path, capsys):
    launch_train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "8", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "2"])
    path = str(tmp_path / "step_00000002.pt")
    params = launch_serve.params_from_checkpoint(
        path, load_config("olmo-1b", "smoke"), "cpu")
    arrays, _ = ckpt.load(path)
    for name, p in params.named_parameters():
        assert torch.equal(p, arrays[f"params/{name}"]) and \
            not p.requires_grad
    res = launch_serve.main(["--device", "cpu", "--params", path,
                             "--batch", "2", "--prompt-len", "4", "--gen",
                             "3"])
    assert res.tokens.shape == (2, 7)
    assert "[serve] olmo-1b on cpu" in capsys.readouterr().out
