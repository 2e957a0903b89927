"""What the profiler saw in the traced window, reduced to numbers.

From ``torch.profiler``'s events: every device operation (kernels, copies,
sets) as a span, the host ranges ``pbcorrect.seed`` / ``.walks`` /
``.replay`` that the corrector opens around its phases, and the window's
own range.  Busy time is the union of the device spans inside the window;
an idle gap is a stretch of the window that no device span covers, named by
the corrector range the host was in at its middle.
"""
from __future__ import annotations

from dataclasses import dataclass, field

WINDOW_RANGE = "pbbench.window"
PHASE_PREFIX = "pbcorrect."


@dataclass
class Trace:
    window: tuple[float, float]                     # us
    ops: list[tuple[float, float, str]]             # device spans, us
    ranges: list[tuple[float, float, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def merged(self) -> list[tuple[float, float]]:
        """The union of the device spans, clipped to the window."""
        a, b = self.window
        out: list[list[float]] = []
        for s, e, _ in sorted(self.ops):
            s, e = max(s, a), min(e, b)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e6

    def op_seconds(self, match) -> float:
        """Device seconds of the operations whose name match(name) accepts."""
        return sum(e - s for s, e, n in self.ops if match(n)) / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        per: dict[str, float] = {}
        for s, e, name in self.ops:
            per[name] = per.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The n longest stretches of the window with the device idle, each
        named by the corrector phase the host was in at its middle."""
        a, b = self.window
        gaps, t = [], a
        for s, e in self.merged():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if b > t:
            gaps.append((t, b))
        gaps.sort(key=lambda g: g[0] - g[1])
        ranges = sorted(self.ranges)
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            # the innermost range around the middle: the latest to start
            name = "host outside pbcorrect"
            for rs, re, rn in ranges:
                if rs > mid:
                    break
                if re >= mid:
                    name = rn
            out.append([name, (e - s) / 1e6])
        return out


def collect(prof) -> Trace | None:
    """The Trace of a finished torch.profiler.profile, or None when it
    recorded no device operation or no window range."""
    from torch.autograd import DeviceType

    ops, ranges, window = [], [], None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a range's device-side shadow is not an operation
            if not e.name.startswith((PHASE_PREFIX, WINDOW_RANGE)):
                ops.append((s, t, e.name))
        elif e.name == WINDOW_RANGE:
            window = (s, t)
        elif e.name.startswith(PHASE_PREFIX):
            ranges.append((s, t, e.name))
    if window is None or not ops:
        return None
    return Trace(window=window, ops=ops, ranges=ranges)
