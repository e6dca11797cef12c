"""echo: the request itself."""

import numpy as np


# Hand-worked answers: (request, reply owed), held by
# benchmark/tests/test_bench_arith.py.
EXAMPLES = [([0, 1, 254, 255], [0, 1, 254, 255]), ([], [])]


def reply(request: np.ndarray) -> np.ndarray:
    return np.array(request, dtype=np.uint8)
