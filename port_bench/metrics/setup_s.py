"""Set-up: from the process's start (the first line of ``run.py``) to the
first timed step's start. Weights made on the card, the port built from
them, the frame pool, the warm-up steps, and on a fresh checkout the kernel
library's build."""

UNIT = "s"
LAYER = "end to end"
MOVES = "setup_s"


def read(record):
    return record.setup_s
