"""idle_between.eval: the share of the quiet pass's steady window (the one
`device_idle.eval` reads) in which the device was idle while the
dispatching thread was inside the port's spans `eval.read`,
`eval.wait_upload`, `eval.collect` or `eval.write`: between dispatches."""

from rrbench import spans


def read(r):
    return spans.idle_share(r, ("eval.read", "eval.wait_upload",
                                "eval.collect", "eval.write"))
