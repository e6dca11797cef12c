"""echo_fanout8: the merged reply of a ParallelChannel over 8 echo
servers, which the p2p fan-out owes: each sub-channel's reply, the
request itself, in sub-channel order, so the request 8 times over (the
core's ParallelChannel merges at completion in channel-index order)."""

import numpy as np

FANOUT = 8
# Hand-worked answers: (request, reply owed), held by
# benchmark/tests/test_bench_arith.py.
EXAMPLES = [([0, 1, 254, 255], [0, 1, 254, 255] * 8), ([7], [7] * 8)]


def reply(request: np.ndarray) -> np.ndarray:
    return np.tile(np.asarray(request, dtype=np.uint8), FANOUT)
