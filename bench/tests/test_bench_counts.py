"""The FLOP and byte counts behind ``train.mfu``, ``serve.mfu`` and the
rooflines, against values worked out by hand at a small shape, and the
readers over a made-up trace."""

from types import SimpleNamespace

import pytest

from bench import counts, harness, trace
from bench.reference.decoder import MoE, Model, param_specs

TINY = Model(n_layers=2, d_model=4, n_heads=2, n_kv_heads=2, d_head=2,
             d_ff=8, vocab_size=10, norm="nonparam_ln", norm_eps=1e-6,
             act="swiglu", rope_theta=1e4, tie_embeddings=True,
             aux_weight=0.01, z_weight=1e-4)
# layer: q 16 + k 16 + v 16 + o 16 = 64; SwiGLU 3 * 4 * 8 = 96
TINY_MOE = Model(**{**TINY.__dict__, "tie_embeddings": False,
                    "moe": MoE(n_experts=4, top_k=2, n_shared=1, d_expert=2,
                               capacity_factor=1.25,
                               layer_pattern="all_but_first",
                               group_tokens=16)})


def test_flops_by_hand():
    assert counts.matmul_params(TINY) == 2 * 160
    assert counts.head_params(TINY) == 40
    # 2 a T (T + 1) L, a = 4, T = 3
    assert counts.causal_attention_flops(TINY, 3) == 2 * 4 * 3 * 4 * 2
    # 3 (2 B T 320 + 2 B (T - 1) 40 + B 192), B = 2, T = 3
    assert counts.train_step_flops(TINY, 2, 3) == 3 * (3840 + 320 + 384)
    assert counts.prefill_flops(TINY, 2, 3) == 3840 + 160 + 384
    # 2 B (320 + 40) + B 4 a (pos + 1) L at pos 3
    assert counts.decode_step_flops(TINY, 2, 3) == 1440 + 2 * 4 * 4 * 4 * 2
    # MoE layer: 64 + router 16 + (2 + 1) * 3 * 4 * 2
    assert counts.layer_matmul_params(TINY_MOE, 0) == 160
    assert counts.layer_matmul_params(TINY_MOE, 1) == 152


def test_bytes_by_hand():
    specs = param_specs(TINY)
    # tied: the table (40) is the readout and counts; 2 layers of 160
    assert counts.weight_bytes(TINY, specs, "bfloat16") == 2 * (40 + 320)
    untied = param_specs(TINY_MOE)
    n = sum(s.numel for s in untied) - 40          # the table is a gather
    assert counts.weight_bytes(TINY_MOE, untied, "float32") == 4 * n
    # 2 L B (pos + 1) Hkv Dh 2: L 2, B 3, pos 4, Hkv 2, Dh 2
    assert counts.kv_bytes(TINY, 3, 4, "bfloat16") == 2 * 2 * 3 * 5 * 2 * 2 * 2
    assert counts.softmax_bytes(3, 5) == 120
    assert counts.forward_softmax_bytes(TINY, ("train", 2, 3, 3)) == \
        2 * 2 * (2 * 2 * 3) * 3 * 4
    assert counts.forward_softmax_bytes(TINY, ("decode", 2, 7, 5)) == \
        2 * 2 * (2 * 2) * 5 * 4
    # 2 B H T (T + 1) / 2 4
    assert counts.causal_exp_bytes(2, 2, 3) == 2 * 2 * 2 * 6 * 4
    assert counts.least_seconds(989e12, 0) == 1.0
    assert counts.least_seconds(0, 3.35e12) == 1.0


@pytest.mark.parametrize("name,softmax,exp", [
    ("void (anonymous namespace)::softmax_cluster_kernel<float, true>"
     "(float const*, float*, long, int, int)", True, False),
    ("void (anonymous namespace)::softmax_warp_kernel<float, 4, 256>(...)",
     True, False),
    ("void (anonymous namespace)::softmax_kernel<float>(...)", True, False),
    ("(anonymous namespace)::exp_vec_kernel(float const*, float*, long, "
     "long)", False, True),
    ("(anonymous namespace)::exp_kernel(float const*, float*, long)", False,
     True),
    ("void at::native::(anonymous namespace)::softmax_warp_forward<float, "
     "float, float, 11, false, false>(...)", False, False),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "exp_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}>(...)",
     False, False),
])
def test_kernel_names(name, softmax, exp):
    assert counts.is_softmax_kernel(name) == softmax
    assert counts.is_exp_kernel(name) == exp


def fake_trace():
    t = trace.TraceData()
    t.window = trace.Span(trace.WINDOW, 0, 1_000_000_000)
    t.units = [trace.Span(trace.UNIT, 0, 1_000_000_000)]
    t.host = [trace.Span(trace.WINDOW, 0, 1_000_000_000),
              trace.Span("cudaDeviceSynchronize", 100_000_000, 200_000_000)]
    t.device = [trace.Span("softmax_cluster_kernel<float>(x)", 0, 1_000_000),
                trace.Span("exp_vec_kernel(x)", 300_000_000, 302_000_000),
                trace.Span("gemm", 400_000_000, 900_000_000),
                trace.Span("copy", 950_000_000, 960_000_000)]
    return t


def test_readers_over_a_trace():
    t = fake_trace()
    assert t.busy_s() == pytest.approx(0.513)
    ctx = SimpleNamespace(
        model=TINY, trace=t, traffic={"kind": "train"},
        units=[{"seconds": 2.0, "tokens": 6, "requests": 2,
                "forwards": [("train", 2, 3, 3)]}])
    mfu = harness.load_metric("train.mfu").read(ctx)
    assert mfu == pytest.approx(100 * 13632 / 2.0 / 989e12)
    sm = harness.load_metric("softmax_roofline.train").read(ctx)
    assert sm == pytest.approx(100 * 576 / 3.35e12 / 1e-3)
    ex = harness.load_metric("exp_roofline.train").read(ctx)
    assert ex == pytest.approx(100 * 2 * 192 / 3.35e12 / 2e-3)
    idle = harness.load_metric("device.idle_share.train").read(ctx)
    assert idle == pytest.approx(100 * (1 - 0.513))
    assert harness.load_metric("device.idle_share.serve").read(ctx) is None
    assert harness.load_metric("softmax_roofline.serve").read(ctx) is None
    ctx.traffic = {"kind": "serve"}
    ctx.units = [{"seconds": 1.0, "requests": 2, "tokens": 4,
                  "decode_steps": 2, "decode_s": 0.5,
                  "forwards": [("prefill", 2, 3, 6), ("decode", 2, 3, 6),
                               ("decode", 2, 4, 6)]}]
    # the three device operations after the prefill's synchronisation
    ops = harness.load_metric("engine.ops_per_decode_step").read(ctx)
    assert ops == 3 / 2
    assert harness.load_metric("tpot_ms").read(ctx) == 250.0
    assert harness.load_metric("exp_roofline.train").read(ctx) is None


def test_decode_ops_start_at_the_prefills_device_sync():
    """The prompts' copy to the card ends in a stream synchronisation
    before the prefill: the decode loop starts at the call's first device
    synchronisation, not at that one."""
    t = trace.TraceData()
    t.window = trace.Span(trace.WINDOW, 0, 1000)
    t.units = [trace.Span(trace.UNIT, 0, 1000)]
    t.host = [trace.Span(trace.WINDOW, 0, 1000),
              trace.Span(trace.UNIT, 0, 1000),
              trace.Span("cudaStreamSynchronize", 10, 20),
              trace.Span("cudaDeviceSynchronize", 400, 500),
              trace.Span("cudaStreamSynchronize", 900, 950)]
    # the prompts' copy, the cache's zeroing and four prefill kernels,
    # then three decode operations and the tokens' copy back
    t.device = [trace.Span(f"op{i}", at, at + 5) for i, at in enumerate(
        [5, 100, 150, 200, 250, 300, 600, 700, 800, 920])]
    ctx = SimpleNamespace(trace=t, traffic={"kind": "serve"},
                          units=[{"decode_steps": 2}])
    assert [h.name for h in t.syncs_in(t.units[0])] == [
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaStreamSynchronize"]
    ops = harness.load_metric("engine.ops_per_decode_step").read(ctx)
    assert ops == 4 / 2


def test_each_metric_reads_the_window_of_its_source():
    """In a traced run the host-clock metrics read the untraced window's
    units, the device-trace metrics the traced units."""
    ctx = harness.Context.__new__(harness.Context)
    ctx.units = [{"seconds": 1.0}]
    ctx.traced_units = [{"seconds": 3.0}, {"seconds": 4.0}]
    assert harness.metric_view(ctx, "host_clock") is ctx
    view = harness.metric_view(ctx, "device_trace")
    assert view.units == ctx.traced_units
    assert ctx.units == [{"seconds": 1.0}]
    assert harness.all_units(ctx) == ctx.units + ctx.traced_units


def test_breakdown_names_the_host_in_each_gap():
    b = trace.breakdown(fake_trace())
    assert b["device_ops"][0][0] == "gemm"
    gaps = dict(b["idle_gaps"])
    # the gap over the synchronisation, and the rest under the window
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(0.299)
    assert sum(gaps.values()) == pytest.approx(1 - 0.513)
