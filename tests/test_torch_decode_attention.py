"""Decode attention over a KV cache (``repro_torch.kernels.decode_attn``,
``ops.decode_scores``, ``ops.decode_pv``).

On the CPU: the plain score product, the softmax and the plain PV product
give the einsum path's output (``attention._scores_pv`` with one query a
row) bit for bit, at every decoder family's group size and head size, a
ragged cache of 1,153 slots, three positions and a sliding window, and at
a position held in a 0-d tensor the bits of the equal int;
``attention()`` takes them for one query a row over a plain cache, and
counts ``decode_kernel`` and ``cache_slots`` on its ``attn.core`` span,
and keeps the einsum path for a prefill, for training and on DTensors; the
wrappers refuse what the kernels do not take; the splits a shape gets.

On the card (marked ``card``; they skip without a CUDA device, and run
with ``python3 -m pytest -m card tests/test_torch_decode_attention.py`` on
a machine with one): the kernels against the plain versions at
``olmo-1b.decode``'s shape and at each family's, the softmax's exact zeros
where the PV kernel skips, the launch counters, and the kernels at
positions that use 1, 2 or all of the PV product's blocks a pair, in bf16
and fp32.  The kernels read the position on the card.  The tolerances are
those of fp32 sums taken in another order: the score products' terms are
exact (bf16 products) and the PV product rounds once to bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import load_config  # noqa: E402
from repro_torch.kernels import decode_attn as D  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.obs import card  # noqa: E402

S = 1153                 # olmo-1b.decode's cache: 1,024 + 128 + 1 slots
WINDOW = 300             # a sliding window shorter than the cache


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_store():
    card.clear()
    yield
    card.clear()


def _cfg(g, dh, window=0, dtype="bfloat16"):
    """The olmo-1b smoke model with 2 KV heads, ``g`` query heads each, head
    size ``dh``."""
    return load_config("olmo-1b", "smoke").replace(
        n_heads=2 * g, n_kv_heads=2, d_head=dh, sliding_window=window,
        dtype=dtype)


def _inputs(B, S, hkv, g, dh, dtype=torch.bfloat16, device="cpu", seed=0):
    """A grouped query (B, 1, Hkv, g, Dh) and a key and a value cache (B, S,
    Hkv, Dh), normal values from numpy."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device=device, dtype=dtype)

    return t(B, 1, hkv, g, dh), t(B, S, hkv, dh), t(B, S, hkv, dh)


def _window(pos, window):
    return (max(0, pos - window + 1) if window else 0), pos + 1


class TestPlain:
    @pytest.mark.parametrize("window", [0, WINDOW], ids=["causal", "window"])
    @pytest.mark.parametrize("pos", [0, S // 2, S - 1],
                             ids=["first", "mid", "last"])
    @pytest.mark.parametrize("dh", [16, 96, 128, 256])
    @pytest.mark.parametrize("g", [1, 4, 8])
    def test_the_chain_is_the_einsum_path(self, g, dh, pos, window):
        cfg = _cfg(g, dh, window)
        qg, k, v = _inputs(2, S, 2, g, dh, seed=g * dh + pos)
        want = A._scores_pv(cfg, qg, k, v, pos, True, torch.bfloat16)
        got = A._decode(cfg, qg, k, v, pos, torch.bfloat16, card.OFF)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert torch.equal(got, want)

    @pytest.mark.parametrize("window", [0, WINDOW], ids=["causal", "window"])
    @pytest.mark.parametrize("pos", [0, WINDOW - 1, S // 2, S - 1],
                             ids=["first", "window", "mid", "last"])
    def test_a_tensor_position_gives_the_ints_bits(self, pos, window):
        qg, k, v = _inputs(2, S, 2, 4, 16, seed=pos + window)
        at = torch.tensor(pos)
        lo, hi = _window(pos, window)
        assert (lo, hi) == D.bounds(pos, window)
        assert [int(b) for b in D.bounds(at, window)] == [lo, hi]
        scores = D.decode_scores_plain(qg, k, lo, hi, 0.25)
        for pos_ in (at, pos):
            assert torch.equal(ops.decode_scores(qg, k, pos_, window, 0.25),
                               scores)
        p = ops.softmax(scores).to(v.dtype)
        assert torch.equal(ops.decode_pv(p, v, at, window),
                           D.decode_pv_plain(p, v, lo, hi))
        cfg = _cfg(4, 16, window)
        assert torch.equal(
            A._decode(cfg, qg, k, v, at, torch.bfloat16, card.OFF),
            A._decode(cfg, qg, k, v, pos, torch.bfloat16, card.OFF))

    def test_masked_slots_and_the_softmax_zeros(self):
        qg, k, _ = _inputs(2, S, 2, 4, 16)
        lo, hi = _window(700, WINDOW)
        scores = D.decode_scores_plain(qg, k, lo, hi, 0.25)
        assert (scores[..., :lo] == D.NEG_INF).all()
        assert (scores[..., hi:] == -torch.inf).all()  # both masks: -inf
        assert torch.isfinite(scores[..., lo:hi]).all()
        p = ops.softmax(scores)
        assert (p[..., :lo] == 0).all() and (p[..., hi:] == 0).all()


def _spy(monkeypatch):
    calls = []
    for name in ("decode_scores", "decode_pv"):
        fn = getattr(ops, name)

        def spied(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(ops, name, spied)
    return calls


def _layer(cfg, seed=0):
    torch.manual_seed(seed)
    p = A.Attention(cfg, "cpu")
    for prm in p.parameters():
        torch.nn.init.normal_(prm, std=0.2)
    return p


class TestRoute:
    @pytest.mark.parametrize("window", [0, 4], ids=["causal", "window"])
    def test_one_query_a_row_over_a_cache(self, monkeypatch, window):
        cfg = _cfg(2, 16, window, dtype="float32")
        p, B, pos = _layer(cfg), 3, 9
        calls = _spy(monkeypatch)
        cache = {n: torch.randn(B, 16, 2, 16) for n in ("k", "v")}
        x = torch.randn(B, 1, cfg.d_model)
        with profile(activities=[ProfilerActivity.CPU]):
            out, _ = A.attention(p, cfg, x, torch.full((B, 1), pos), cache,
                                 pos)
        assert calls == ["decode_scores", "decode_pv"]
        (core,) = [r for r in card.read() if r.name == "attn.core"]
        lo, hi = _window(pos, window)
        assert core.counters == {"decode_kernel": 1,
                                 "cache_slots": B * (hi - lo)}
        assert out.shape == (B, 1, cfg.d_model)

    @pytest.mark.parametrize("window", [0, 4], ids=["causal", "window"])
    def test_a_tensor_position(self, monkeypatch, window):
        """The keys and values land at the position, as at the int, and
        the span counts the same slots."""
        cfg = _cfg(2, 16, window, dtype="float32")
        p, B, pos = _layer(cfg), 3, 9
        calls = _spy(monkeypatch)
        x = torch.randn(B, 1, cfg.d_model)
        outs, caches = [], []
        for at in (pos, torch.tensor(pos)):
            cache = {n: torch.randn(B, 16, 2, 16,
                                    generator=torch.Generator().manual_seed(1))
                     for n in ("k", "v")}
            with profile(activities=[ProfilerActivity.CPU]):
                out, _ = A.attention(p, cfg, x, torch.full((B, 1), pos),
                                     cache, at)
            outs.append(out)
            caches.append(cache)
        assert calls == ["decode_scores", "decode_pv"] * 2   # one route
        assert torch.equal(outs[0], outs[1])
        assert all(torch.equal(caches[0][n], caches[1][n]) for n in "kv")
        cores = [r for r in card.read() if r.name == "attn.core"]
        lo, hi = _window(pos, window)
        assert [r.counters for r in cores] == [
            {"decode_kernel": 1, "cache_slots": B * (hi - lo)}] * 2

    def test_not_for_a_prefill_or_training(self, monkeypatch):
        cfg = _cfg(2, 16, dtype="float32")
        p, B, T = _layer(cfg), 2, 5
        calls = _spy(monkeypatch)
        x = torch.randn(B, T, cfg.d_model)
        positions = torch.arange(T)[None].expand(B, T)
        cache = {n: torch.zeros(B, 16, 2, 16) for n in ("k", "v")}
        with profile(activities=[ProfilerActivity.CPU]):
            A.attention(p, cfg, x, positions, cache, 0)       # prefill
            A.attention(p, cfg, x[:, :1], positions[:, :1])   # no cache
        assert calls == []
        cores = [r for r in card.read() if r.name == "attn.core"]
        assert len(cores) == 2 and all(r.counters == {} for r in cores)

    def test_not_on_dtensors(self, monkeypatch):
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_mesh
        cfg = _cfg(2, 16, dtype="float32")
        p, B, pos = _layer(cfg), 2, 5
        calls = _spy(monkeypatch)
        with dryrun.fake_world(4):
            mesh = make_mesh((2, 2), ("data", "model"), "cpu")

            def placed(t, pl=(Replicate(), Replicate())):
                return DTensor.from_local(t, mesh, list(pl), run_check=False)

            for name, prm in list(p.named_parameters()):
                mod, attr = name.rsplit(".", 1)
                setattr(p.get_submodule(mod), attr,
                        torch.nn.Parameter(placed(prm.data)))
            rows = (Shard(0), Replicate())
            cache = {n: placed(torch.zeros(B, 16, 2, 16), rows)
                     for n in ("k", "v")}
            out, _ = A.attention(
                p, cfg, placed(torch.randn(B, 1, cfg.d_model), rows),
                placed(torch.full((B, 1), pos), rows), cache, pos)
        assert isinstance(out, DTensor) and calls == []


class TestWrapper:
    def test_a_cpu_tensor_under_impl_cuda(self):
        qg, k, v = _inputs(1, 32, 2, 1, 16)
        at = torch.tensor(4)
        with pytest.raises(ValueError, match="impl='cuda'"):
            ops.decode_scores(qg, k, at, 0, 0.25, impl="cuda")
        p = torch.zeros(1, 2, 1, 1, 32, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="impl='cuda'"):
            ops.decode_pv(p, v, at, 0, impl="cuda")
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            D.decode_scores_cuda(qg, k, at, 0, 0.25)
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            D.decode_pv_cuda(p, v, at, 0)

    @pytest.mark.parametrize("case", [
        "float16", "mixed dtypes", "strided cache", "head size 12",
        "head size 264", "16 heads a KV head", "query shape",
        "negative window", "int position", "int32 position",
        "position of one element", "position of two"])
    def test_refuses_what_the_kernel_does_not_take(self, case):
        g, dh, pos, window = 1, 16, torch.tensor(4), 0
        if case == "head size 12":
            dh = 12
        if case == "head size 264":
            dh = 264
        if case == "16 heads a KV head":
            g = 16
        qg, k, _ = _inputs(1, 32, 2, g, dh)
        if case == "float16":
            qg, k = qg.half(), k.half()
        if case == "mixed dtypes":
            qg = qg.float()
        if case == "strided cache":
            k = k.transpose(0, 1).contiguous().transpose(0, 1)
        if case == "query shape":
            qg = qg[:, :, :1].contiguous()
        if case == "negative window":
            window = -1
        if case == "int position":
            pos = 4
        if case == "int32 position":
            pos = pos.int()
        if case == "position of one element":
            pos = pos.reshape(1)
        if case == "position of two":
            pos = torch.tensor([4, 5])
        err = ValueError if case.startswith(("head", "16", "query", "strided",
                                             "negative")) else TypeError
        with pytest.raises(err, match="decode_scores_cuda"):
            D.decode_scores_cuda(qg, k, pos, window, 0.25)

    @pytest.mark.parametrize("pairs,rows,dh,want", [
        (128 * 16, S, 128, 1),     # olmo-1b.decode: the card full already
        (4 * 16, 161, 128, 4),     # batch 4, prompt 128: 32 slots a pass
        (1 * 8, 8192, 128, 8),     # Jamba at batch 1: eight blocks a pair
        (4 * 16, 60, 128, 1),      # under two passes: one block
        (2, 4096, 256, 8),         # Gemma's MQA at batch 2
        (264, 4096, 16, 1)])
    def test_splits(self, pairs, rows, dh, want):
        assert D.splits(pairs, rows, dh) == want

    @pytest.mark.parametrize("dh,lanes", [(8, 1), (16, 2), (24, 4), (96, 16),
                                          (128, 16), (256, 32)])
    def test_lanes_per_slot(self, dh, lanes):
        assert D.lanes_per_slot(dh) == lanes


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _against_plain(cuda, B, S, hkv, g, dh, pos, window=0,
                   dtype=torch.bfloat16):
    """The kernels against the plain versions at one shape; returns the
    kernel's probabilities' zeros outside [lo, hi) and its PV output."""
    qg, k, v = _inputs(B, S, hkv, g, dh, dtype, cuda, seed=B + g + dh)
    lo, hi = _window(pos, window)
    at = torch.tensor(pos, device=cuda)
    scale = dh ** -0.5
    got = D.decode_scores_cuda(qg, k, at, window, scale)
    want = D.decode_scores_plain(qg, k, lo, hi, scale)
    assert got.shape == want.shape and got.dtype == torch.float32
    # fp32 sums of exact products, in another order.
    torch.testing.assert_close(got[..., lo:hi], want[..., lo:hi],
                               rtol=1e-5, atol=1e-4)
    assert (got[..., :lo] == D.NEG_INF).all()
    assert (got[..., hi:] == D.NEG_INF).all()
    p = ops.softmax(got).to(dtype)
    # the PV kernel skips the slots outside [lo, hi): exact only if the
    # softmax gives 0 there
    assert (p[..., :lo] == 0).all() and (p[..., hi:] == 0).all()
    out = D.decode_pv_cuda(p, v, at, window)
    ref = D.decode_pv_plain(p, v, lo, hi)
    assert out.shape == ref.shape and out.dtype == dtype
    # one rounding to the dtype from fp32 sums in another order: 1 ulp
    tol = dict(rtol=1e-2, atol=1e-5) if dtype == torch.bfloat16 else \
        dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out, ref, **tol)
    assert torch.equal(out, D.decode_pv_cuda(p, v, at, window))   # repeats
    return out


@pytest.mark.card
class TestCard:
    @pytest.mark.parametrize("pos", [0, S // 2, S - 1],
                             ids=["first", "mid", "last"])
    def test_the_cell_shape(self, cuda, pos):
        _against_plain(cuda, 128, S, 16, 1, 128, pos)

    @pytest.mark.parametrize("family,B,S_,hkv,g,dh,pos,window", [
        ("phi3-mini", 4, 161, 32, 1, 96, 150, 0),
        ("gemma-2b", 4, 161, 1, 8, 256, 150, 0),
        ("qwen3", 4, 161, 8, 8, 128, 129, 0),
        ("grok-1", 4, 161, 8, 6, 128, 140, 0),
        ("jamba", 1, 8192, 8, 4, 128, 7170, 4096),
        ("smoke", 2, 40, 2, 2, 16, 30, 0)])
    def test_each_family(self, cuda, family, B, S_, hkv, g, dh, pos, window):
        _against_plain(cuda, B, S_, hkv, g, dh, pos, window)

    @pytest.mark.parametrize("g", [1, 2, 4])
    def test_fp32_caches(self, cuda, g):
        _against_plain(cuda, 2, 40, 2, g, 16, 30, dtype=torch.float32)

    def test_the_chain_against_the_einsum_path(self, cuda):
        cfg = _cfg(4, 128, WINDOW)
        qg, k, v = _inputs(4, S, 2, 4, 128, device=cuda)
        want = A._scores_pv(cfg, qg, k, v, 900, True, torch.bfloat16)
        got = A._decode(cfg, qg, k, v, 900, torch.bfloat16, card.OFF)
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-3)

    def test_the_launch_counters(self, cuda):
        qg, k, v = _inputs(2, 64, 2, 1, 128, device=cuda)
        s0, p0 = D.decode_scores_cuda.launches, D.decode_pv_cuda.launches
        at = torch.tensor(39, device=cuda)
        scores = ops.decode_scores(qg, k, at, 0, 0.1)
        ops.decode_pv(ops.softmax(scores).to(v.dtype), v, at, 0)
        assert D.decode_scores_cuda.launches == s0 + 1
        assert D.decode_pv_cuda.launches == p0 + 1

    @pytest.mark.parametrize("B,S_,hkv,g,dh,pos,window", [
        (128, S, 16, 1, 128, 1088, 0),     # olmo-1b.decode: one block a pair
        (128, S, 16, 1, 128, 0, 0),
        (4, 161, 16, 1, 128, 144, 0),      # batch 4: 4 blocks a pair
        (4, 161, 16, 1, 128, 40, 0),       # ... of which the slots use 1
        (4, 161, 16, 1, 128, 100, 0),      # ... and 2
        (1, 8192, 8, 4, 128, 7170, 4096),  # Jamba's window, 8 blocks a pair
        (2, 40, 2, 2, 16, 30, 0)],
        ids=["cell", "cell-first", "b4", "b4-one", "b4-two", "jamba",
             "smoke"])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                             ids=["bf16", "f32"])
    def test_a_position_on_the_card(self, cuda, B, S_, hkv, g, dh, pos,
                                    window, dtype):
        """At positions that use 1, 2 or all of the PV product's blocks a
        pair (its grid sized from the cache, its blocks from the position),
        the kernels give the plain versions' results and repeat."""
        _against_plain(cuda, B, S_, hkv, g, dh, pos, window, dtype)
