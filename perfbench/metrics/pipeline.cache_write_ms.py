"""pipeline.cache_write_ms: the device time an edit spends writing the
frozen K / V cache, in ms: the CUDA-event times of the program's
`model.cache_write` spans (each layer's K or V image rows stored by a
write forward: copied in the model dtype, or quantized to int8 / int4
rows and fp32 scales), summed over the traced edits and divided by their
number (`regione_tpu_torch.utils.telemetry`).  None where the program
records no such span or no device time for one, or records another
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
    ms = [s.device_ms() for s in spans if s.name == "model.cache_write"]
    if not ms or None in ms:
        return None
    return sum(ms) / len(run.edits)
