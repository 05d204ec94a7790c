"""Serving: the batched decode engine (``serve.engine``) plus the
discrete-event serving simulator — arrival traces (``serve.traffic``),
the event loop and service pricer (``serve.sim``), and autoscaling
policies (``serve.policies``), copies of the JAX package's.

The engine is deliberately NOT imported here: it pulls in the model
stack (PyTorch and the CUDA kernels' wrappers), while the simulator runs
purely on the analytic cost models — ``from repro_torch.serve import
simulate`` loads no ``repro_torch.models`` module.
"""

from repro_torch.resilience.failover import FailoverPolicy, RetryPolicy
from repro_torch.resilience.faults import FaultTrace, make_faults
from repro_torch.serve.policies import (POLICIES, ModelPredictivePolicy,
                                        Policy, ReactivePolicy, StaticPolicy,
                                        plan_for_rate, plan_grid)
from repro_torch.serve.sim import (PERCENTILES, PolicyContext, ServicePricer,
                                   SimReport, SloSpec, SlotPlan, simulate)
from repro_torch.serve.traffic import (TRACE_FAMILIES, Request, Trace,
                                       make_trace)

__all__ = [
    "Request", "Trace", "make_trace", "TRACE_FAMILIES",
    "SloSpec", "SlotPlan", "PolicyContext", "ServicePricer", "SimReport",
    "simulate", "PERCENTILES",
    "Policy", "StaticPolicy", "ReactivePolicy", "ModelPredictivePolicy",
    "plan_grid", "plan_for_rate", "POLICIES",
    # Resilience surface (re-exported: simulate(faults=..., retry=...)
    # consumes these; repro_torch.resilience is the home package).
    "FaultTrace", "make_faults", "RetryPolicy", "FailoverPolicy",
]
