"""The program's ``load:<Op>`` spans over the whole run: each op's weights
read, converted and put on the card at their first use, which the warm
packet of set-up pays."""

from portbench.metrics import _program

_program.install()

UNIT = "s"


def read(run):
    loads = [e - s for name, ivs in run.spans.items()
             if name.startswith("load:") for s, e in ivs]
    if run.busy_s is None or not loads:
        return None
    return sum(loads)
