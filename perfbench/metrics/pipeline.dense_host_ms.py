"""pipeline.dense_host_ms: the mean host time of one `pipeline.dense_forward`
span of the program (its enqueue of a dense forward; the span adds no
sync), over the traced edits, from the spans the port records while the
profiler runs (`regione_tpu_torch.utils.telemetry`).  In every cell the
device falls behind over the back-to-back dense forwards, so this time
also holds the host's waits for room in the launch queue: it reads the
device's pace more than the host's cost, and falls when the device gets
faster.  None where the program records no spans, or records another
number of `pipeline.edit` spans than the run has edits."""


def read(run):
    try:
        from regione_tpu_torch.utils import telemetry
    except ImportError:
        return None
    if not run.edits or not hasattr(telemetry, "spans"):
        return None
    spans = telemetry.spans()
    if sum(s.name == "pipeline.edit" for s in spans) != len(run.edits):
        return None
    ms = [s.host_ms for s in spans if s.name == "pipeline.dense_forward"]
    return sum(ms) / len(ms) if ms else None
