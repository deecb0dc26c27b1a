"""The program's flight-recorder spans over the window.

The seconds of every span named in ``spec["spans"]`` that started in the
window, over the number of ``spec["per"]`` spans that did, times
``spec["scale"]``: for ``scene.read`` per ``scene.read``, ms a stack; for
``scene.write`` and ``scene.checkpoint`` per ``scene.write``, ms a granule.
"""

from __future__ import annotations

from typing import Optional


def read(spec: dict, obs) -> Optional[float]:
    if not obs.spans:
        return None
    w0, w1 = obs.window.t0, obs.window.t1
    names = set(spec["spans"])
    total, per = 0.0, 0
    for name, s0, s1, _ in obs.spans:
        if not w0 <= s0 <= w1:
            continue
        if name in names:
            total += s1 - s0
        if name == spec["per"]:
            per += 1
    if per == 0:
        return None
    return total / per * spec.get("scale", 1.0)
