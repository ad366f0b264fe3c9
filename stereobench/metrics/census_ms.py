"""Device ms per pair of the SGM forward's ``census`` stage: both views'
casts to int32 and census transforms (``ops/costvolume.py``), torch ops.
The program's own span: from the stream reaching the stage's start event
to reaching its end event, summed over the traced requests and divided
by their pairs (``metrics/_spans.py``).  Where the device is busy it is
the stage's device time; where the host paces the device it also holds
the waits for the host's launches inside the stage."""

from stereobench.metrics._spans import stage_ms

LAYER = "torch ops"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "pairs_per_s"


def read(r):
    return stage_ms("census")
