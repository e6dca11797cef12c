"""xor255: every byte of the request xor 0xFF."""

import numpy as np


# Hand-worked answers: (request, reply owed), held by
# benchmark/tests/test_bench_arith.py.
EXAMPLES = [([0, 1, 254, 255], [255, 254, 1, 0]), ([0x0F], [0xF0])]


def reply(request: np.ndarray) -> np.ndarray:
    return np.asarray(request, dtype=np.uint8) ^ np.uint8(0xFF)
