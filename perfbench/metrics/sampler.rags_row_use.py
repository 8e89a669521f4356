"""sampler.rags_row_use: the edited tokens over the RAGS capacity summed
over the traced edits, in percent: the share of the RAGS rows that carry
a token."""


def read(run):
    cap = sum(e["stats"]["capacity"] for e in run.edits
              if e["stats"]["rags_steps"])
    used = sum(e["stats"]["edited_tokens"] for e in run.edits
               if e["stats"]["rags_steps"])
    return 100.0 * used / cap if cap else None
