"""drain_ms.eval: host ms a batch of the traced stretch's quiet pass in
the port's spans `eval.collect` and `eval.write`, less `eval.copy`: the
host's own work on a finished batch (rows, merge, result files)."""

from rrbench import spans


def read(r):
    return spans.ms_a_batch(r, ("eval.collect", "eval.write"),
                            less=("eval.copy",))
