"""kernels.wrapper_host_us: the host time of the port's kernel wrappers
(K1/K5, K2, K2q, K6, K3, K7-K9) per launch over the traced edits: the sum
of their `.host_ns` counters over the sum of their launches, as each
`pipeline.edit` span of the program stores them
(`regione_tpu_torch.utils.telemetry`).  `.host_ns` runs from a wrapper's
entry to its launch call (checks, allocations, arguments), so it reads
the wrappers' own host cost in every cell: the launch call, which waits
for room in the launch queue where the device is behind (the 1024^2
cells), is `.launch_ns`, which this metric leaves out.  None where the
program records no spans, or records another number of `pipeline.edit`
spans than the run has edits."""


def read(run):
    try:
        from regione_tpu_torch.utils import telemetry
    except ImportError:
        return None
    if not run.edits or not hasattr(telemetry, "spans"):
        return None
    edits = [s for s in telemetry.spans() if s.name == "pipeline.edit"]
    if len(edits) != len(run.edits):
        return None
    launches = sum(s.attrs.get("launches", 0) for s in edits)
    host_ns = sum(s.attrs.get("host_ns", 0) for s in edits)
    return host_ns / launches / 1e3 if launches else None
