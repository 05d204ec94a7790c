"""The port's serving path on the CPU: ``ServeEngine.generate`` against the
JAX package's engine on olmo-1b smoke and on the MoE, Mamba-hybrid and
RWKV-6 smoke configs (greedy and sampled tokens identical), the engine's ValueErrors and ``n_steps=0`` as tests/test_serve.py
pins them for JAX, the ``launch.serve`` entry point, and the rule that the
port imports neither JAX nor the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import load_config as jax_load_config  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.engine import _mix32 as jax_mix32  # noqa: E402
from repro_torch.configs import load_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve.engine import ServeEngine, _mix32  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def olmo():
    jcfg = jax_load_config("olmo-1b", "smoke")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    cfg = load_config("olmo-1b", "smoke")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _engine(**kw):
    """Generate validates before it touches the model, so a placeholder
    config exercises every guard."""
    kw.setdefault("batch", 2)
    kw.setdefault("max_len", 32)
    return ServeEngine(object(), None, device="cpu", **kw)


class TestGenerateMatchesJax:
    @pytest.mark.parametrize("kw", [dict(), dict(temperature=1.0, seed=1)],
                             ids=["greedy", "sampled"])
    def test_tokens_identical(self, olmo, kw):
        jcfg, jparams, cfg, params = olmo
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 8)).astype(np.int32)
        want = JaxServeEngine(jcfg, jparams, max_len=32, batch=2,
                              **kw).generate(prompts, 12)
        got = ServeEngine(cfg, params, max_len=32, batch=2, device="cpu",
                          **kw).generate(prompts, 12)
        assert got.steps == want.steps == 12
        assert got.tokens.dtype == want.tokens.dtype
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got.logits.shape == (2, 12, cfg.vocab_size)
        assert bool(torch.isfinite(got.logits).all())
        assert got.prefill_s > 0 and got.decode_s > 0

    @pytest.mark.parametrize("kw", [dict(), dict(temperature=1.0, seed=1)],
                             ids=["greedy", "sampled"])
    @pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b",
                                      "rwkv6-1.6b"])
    def test_family_tokens_identical(self, arch, kw):
        """The KV, Mamba (conv, h) and RWKV (x_prev, S, cm_prev) caches
        carried across a prefill and 10 decode steps."""
        jcfg = jax_load_config(arch, "smoke")
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(2))
        cfg = load_config(arch, "smoke")
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 "cpu")
        prompts = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, 8)).astype(np.int32)
        want = JaxServeEngine(jcfg, jparams, max_len=24, batch=2,
                              **kw).generate(prompts, 10)
        got = ServeEngine(cfg, params, max_len=24, batch=2, device="cpu",
                          **kw).generate(prompts, 10)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert bool(torch.isfinite(got.logits).all())

    def test_greedy_tokens_are_the_argmax_of_their_logits(self, olmo):
        _, _, cfg, params = olmo
        prompts = np.arange(10, dtype=np.int32).reshape(2, 5)
        res = ServeEngine(cfg, params, max_len=16, batch=2,
                          device="cpu").generate(prompts, 6)
        np.testing.assert_array_equal(res.tokens[:, 5:],
                                      res.logits.argmax(-1).numpy())

    def test_mix32_matches_jax(self):
        for words in [(0,), (1, 2, 3), (2 ** 32 - 1, 2 ** 40, -5)]:
            assert _mix32(*words) == jax_mix32(*words)


class TestEngineGuards:
    def test_n_steps_zero_returns_exactly_the_prompt(self):
        prompts = np.arange(8, dtype=np.int32).reshape(2, 4)
        res = _engine().generate(prompts, 0)
        assert res.steps == 0 and res.tokens.shape == (2, 4)
        np.testing.assert_array_equal(res.tokens, prompts)

    def test_bad_batch_dim_is_a_valueerror_naming_the_dimension(self):
        eng = _engine(batch=2)
        with pytest.raises(ValueError, match=r"batch dimension is 3"):
            eng.generate(np.zeros((3, 4), np.int32), 0)
        with pytest.raises(ValueError, match=r"batch=2"):
            eng.generate(np.zeros((3, 4), np.int32), 0)

    def test_negative_steps_and_overlong_decode_are_valueerrors(self):
        eng = _engine(max_len=16)
        with pytest.raises(ValueError, match=r"n_steps=-1"):
            eng.generate(np.zeros((2, 4), np.int32), -1)
        with pytest.raises(ValueError, match=r"max_len=16"):
            eng.generate(np.zeros((2, 10), np.int32), 7)

    def test_card_is_the_default_device(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(object(), None)


class TestLaunch:
    def test_main_on_cpu(self, capsys):
        res = launch_serve.main(["--device", "cpu", "--batch", "2",
                                 "--prompt-len", "6", "--gen", "5"])
        assert res.tokens.shape == (2, 11)
        assert ((res.tokens >= 0) & (res.tokens < 503)).all()
        assert "[serve] olmo-1b on cpu" in capsys.readouterr().out

    def test_main_is_deterministic_in_its_seed(self):
        argv = ["--device", "cpu", "--batch", "1", "--prompt-len", "4",
                "--gen", "3", "--temperature", "1.0", "--seed", "5"]
        a = launch_serve.main(argv)
        b = launch_serve.main(argv)
        np.testing.assert_array_equal(a.tokens, b.tokens)


#: Imports every module of the port in a fresh interpreter and prints the
#: modules it walked and those of ``sys.modules`` matching ``forbidden``;
#: fails too if an import made a process group or loaded PyTorch's private
#: fake process group (``launch.dryrun`` imports it inside ``fake_world``).
_IMPORT_ALL = (
    "import importlib, pkgutil, sys\n"
    "import repro_torch\n"
    "import repro_torch.api, repro_torch.core, repro_torch.kernels.ops\n"
    "import repro_torch.cluster, repro_torch.system, repro_torch.perf\n"
    "import repro_torch.obs, repro_torch.cluster.analytics\n"
    "import repro_torch.serve, repro_torch.resilience\n"
    "assert repro_torch.api.kernel('logf').op.startswith('repro_torch.')\n"
    "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
    " 'repro_torch.')]\n"
    "for m in mods: importlib.import_module(m)\n"
    "bad = sorted(m for m in sys.modules if forbidden(m))\n"
    "import torch.distributed as dist\n"
    "if dist.is_initialized(): bad.append('a process group')\n"
    "bad += [m for m in sys.modules if m.endswith('distributed.fake_pg')]\n"
    "print(len(mods), bad)\n"
    "print(*mods)\n"
    "sys.exit(1 if bad or len(mods) < 100 else 0)\n")


def _import_all(forbidden: str) -> list[str]:
    code = f"forbidden = {forbidden}\n" + _IMPORT_ALL
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.splitlines()[1].split()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Nor networkx, which the card's machine does not have: the analytic
    model's partitioner runs on the port's own ordered digraph."""
    mods = _import_all("lambda m: m == 'jax' or m.startswith(('jax.', "
                       "'jaxlib')) or m == 'repro' or m.startswith('repro.')"
                       " or m.split('.')[0] == 'networkx'")
    for m in ("train.optimizer", "train.train_step", "train.checkpoint",
              "train.fault", "data.pipeline", "obs.metrics", "obs.record",
              "launch.train", "models.moe", "models.ssm", "perf.memo",
              "obs.spans", "core.timing", "core.dfg", "core.copift",
              "cluster.contention", "system.topology", "api.evaluate",
              "obs.session", "obs.export", "obs.attrib", "obs.history",
              "obs.report", "obs.trace", "cluster.analytics", "system.noc",
              "system.scheduler", "system.analytics",
              "configs.deepseek_moe_16b", "configs.rwkv6_1_6b",
              "resilience", "resilience.faults", "resilience.degrade",
              "resilience.failover", "serve.traffic", "serve.sim",
              "serve.policies", "parallel", "parallel.compress",
              "parallel.sharding", "parallel.autoshard", "launch.mesh",
              "launch.specs", "launch.dryrun", "launch.comm_analysis"):
        assert f"repro_torch.{m}" in mods, m


def test_the_simulator_imports_no_model_code():
    """``import repro_torch.serve`` (the simulator, as the JAX package's
    ``repro.serve``) loads no ``repro_torch.models`` module and not the
    decode engine."""
    code = ("import sys\n"
            "from repro_torch.serve import simulate, make_faults\n"
            "bad = sorted(m for m in sys.modules if m.startswith(("
            "'repro_torch.models', 'repro_torch.serve.engine', 'jax', "
            "'repro.')) or m == 'repro')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_does_not_import_msgpack():
    """The card's machine has no msgpack: checkpoints use ``torch.save``."""
    _import_all("lambda m: m.split('.')[0] == 'msgpack'")
