"""result_wait_ms.eval: host ms a batch of the traced stretch's quiet pass
in the port's span `eval.copy`: the blocking device-to-host copies of the
packed rows, which wait for all the work queued before them."""

from rrbench import spans


def read(r):
    return spans.ms_a_batch(r, ("eval.copy",))
