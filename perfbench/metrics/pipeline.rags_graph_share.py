"""pipeline.rags_graph_share: the share of the traced edits' computed RAGS
forwards that replayed from a CUDA graph, in %: the replays over the
replays and the eager runs, as each `pipeline.edit` span of the program
stores its edit's counts in its attrs (`pipeline.rags_graph.replays`,
`.eager`; `regione_tpu_torch.pipelines.base.RagsGraphs`).  None where the
program records no spans or no such counts, records another number of
`pipeline.edit` spans than the run has edits, or ran no computed RAGS
forward."""


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
    keys = ("pipeline.rags_graph.replays", "pipeline.rags_graph.eager")
    if not all(k in s.attrs for s in edits for k in keys):
        return None
    replays = sum(s.attrs[keys[0]] for s in edits)
    computed = replays + sum(s.attrs[keys[1]] for s in edits)
    return 100.0 * replays / computed if computed else None
