"""The client process of a cell whose servers live in another process:
it builds the load generator, makes its payloads from the seed and the
answers the reference owes them, warms up, then runs the window when its
parent says so. It speaks one JSON line at a time: it reads its set-up,
answers {"ready": ...}, reads "go", answers {"window": ...}, and ends when
its input closes. It never touches the card.

Run as `python benchmark/harness/client.py` from the checkout's root.
"""

from __future__ import annotations

import base64
import json
import os
import sys

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))))]

from harness import gen, reference, traffic as traffic_mod  # noqa: E402
from harness.guard import forbidden_modules, own_segments  # noqa: E402


def _say(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    setup = json.loads(sys.stdin.readline())
    mix = setup["traffic"]
    from tbus_torch import rpc

    rpc.init(mix["client_workers"])
    _, build_s = gen.build()
    payloads = traffic_mod.payloads(mix, setup["seed"])
    expected = reference.replies(setup["rule"], payloads)
    loop = gen.Loop(payloads, expected, setup["service"], mix["method"],
                    mix["timeout_ms"], addr=setup["addr"])
    try:
        warm = loop.run(calls=mix["warmup_calls_per_client"],
                        rate=mix["rate"])
        _say({"ready": {"build_s": build_s, **warm.as_dict()}})
        if sys.stdin.readline().strip() != "go":
            return 1
        res = loop.run(seconds=setup["seconds"], rate=mix["rate"])
        _say({"window": res.as_dict(),
              "latencies": base64.b64encode(
                  res.latencies_ns.tobytes()).decode(),
              "stage_stats": rpc.stage_stats(),
              "forbidden": forbidden_modules(),
              "segments": sorted(own_segments())})
        sys.stdin.read()  # until the parent closes our input
    finally:
        loop.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
