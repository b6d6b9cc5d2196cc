"""idle_issue.eval: the share of the quiet pass's steady window (the one
`device_idle.eval` reads) in which the device was idle while the
dispatching thread was inside the port's span `eval.dispatch`."""

from rrbench import spans


def read(r):
    return spans.idle_share(r, ("eval.dispatch",))
