"""A count the program's flight-recorder spans carry as meta, over the
window.

The sum of ``meta[spec["meta"]]`` over every span named in
``spec["spans"]`` that started in the window, over the number of
``spec["per"]`` spans that did, times ``spec["scale"]``: for ``minflt``
of ``scene.read`` per ``scene.read``, the minor page faults a stack. A
count of 0 is a value; None where no ``per`` span started in the window,
or where no named span carries the count (a program that keeps none).
"""

from __future__ import annotations

from typing import Optional


def read(spec: dict, obs) -> Optional[float]:
    if not obs.spans:
        return None
    w0, w1 = obs.window.t0, obs.window.t1
    names, key = set(spec["spans"]), spec["meta"]
    total, per, counted = 0.0, 0, False
    for name, s0, _, meta in obs.spans:
        if not w0 <= s0 <= w1:
            continue
        if name in names and key in meta:
            total += float(meta[key])
            counted = True
        if name == spec["per"]:
            per += 1
    if per == 0 or not counted:
        return None
    return total / per * spec.get("scale", 1.0)
