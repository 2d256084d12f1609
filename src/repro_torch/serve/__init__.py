"""The request path of the port (twin of ``repro.serve``): query
coalescing over fixed tile shapes, multi-tenant sessions behind one
process, and a seeded Poisson load harness.  Scheduling never changes
math: coalesced responses are bitwise-identical to direct
``AnnEngine`` calls on the same rows."""
from repro_torch.serve.coalescer import (Coalescer, FlushBatch, FlushSlice,
                                         PendingRequest, ServeError)
from repro_torch.serve.loadgen import (RequestSpec, make_workload,
                                       poisson_arrivals, run_closed_loop,
                                       run_open_loop, summarize)
from repro_torch.serve.loop import ServingLoop
from repro_torch.serve.tenants import (Tenant, load_tenants,
                                       parse_tenant_specs)

__all__ = [
    "Coalescer", "FlushBatch", "FlushSlice", "PendingRequest", "ServeError",
    "RequestSpec", "make_workload", "poisson_arrivals", "run_closed_loop",
    "run_open_loop", "summarize",
    "ServingLoop",
    "Tenant", "load_tenants", "parse_tenant_specs",
]
