"""Host-staged wavefront driver: later bounces run on a narrowed slice.

The port of ``kazen_tpu/integrate/staged.py``. ``li_wavefront`` runs every
bounce at the full lane width, though once Russian roulette and escapes have
ended most paths, a bounce's fixed full-width work (the permute and the
masked shade stage) outweighs its rays.

The ordered wavefront keeps an invariant this driver uses: its per-bounce
permute key carries an alive-first tier bit (path_mis._bounce_ordered), so
after bounce k the lanes still alive form a prefix of length sum(alive).
Every lane that can do any work in bounce k+1 (shade, shadow ray, path ray,
background on a miss) lies in that prefix; the suffix lanes are finished and
their state is final. So bounce k+1 runs on the smallest width of a menu
that covers the prefix, and the suffix is appended back untouched.

Exactness: the permute is a stable argsort, and every lane of the suffix
sorts last with the same key in both drivers, so the narrowed bounce puts
its lanes in the order the full-width bounce puts them. Each lane's radiance
and the ray count then equal ``li_wavefront``'s bit for bit wherever every
stage is per lane: on the CPU (tests/test_torch_staged.py) and with the
trace kernels (chip_smoke.py phase 10). Only the returned stream state of
finished lanes differs, which no caller reads (a render pass seeds its
streams anew).

Two modes (``StagedWavefront.run``): sync mode reads the alive count on the
host after each bounce (one device sync per bounce) and picks the next
width; pipelined mode takes a width schedule from an earlier pass
(``PassRecord.plan``) and syncs only when the caller checks
``PassRecord.ok``.
"""
from __future__ import annotations

import torch

from ..samplers.streams import StreamState
from . import path_mis

# _OState fields by how they are sliced to the lane prefix: lane-major
# tensors and the stream on their first axis, the trace rows (40, N) on
# their second; the ray count (a scalar) is carried whole
_LANE_FIELDS = (
    "ray_o", "ray_d", "li", "throughput", "eta", "bsdf_pdf", "discrete",
    "accum_rough", "alive", "lane",
)


def _default_widths(n):
    """Width menu: the full width, then powers of two down to
    max(1024, n/32)."""
    ws = [n]
    w = 1 << max((n - 1).bit_length() - 1, 0)
    while w >= 1024 and w >= n // 32:
        if w < n:
            ws.append(w)
        w >>= 1
    return ws


def _slice_state(st: path_mis._OState, m: int) -> path_mis._OState:
    """The first ``m`` lanes of the state."""
    return st._replace(
        stream=StreamState(*(f[:m] for f in st.stream)),
        rows=st.rows[:, :m],
        **{name: getattr(st, name)[:m] for name in _LANE_FIELDS},
    )


def _concat_state(head: path_mis._OState, full: path_mis._OState) -> path_mis._OState:
    """The full-width state: the updated prefix ``head`` and the untouched
    suffix of ``full``; the ray count comes from ``head``."""
    m = head.ray_o.shape[0]
    return head._replace(
        stream=StreamState(*(torch.cat([a, b[m:]]) for a, b in zip(head.stream, full.stream))),
        rows=torch.cat([head.rows, full.rows[:, m:]], dim=1),
        **{
            name: torch.cat([getattr(head, name), getattr(full, name)[m:]])
            for name in _LANE_FIELDS
        },
    )


class StagedWavefront:
    """A driver for one (static, lane width): build once, call ``run`` once
    per pass.

    ``init_fn(scene, *args)`` returns ``(state, *extras)``, where state is
    the path_mis._OState of path_mis.wavefront_init (callers fold their own
    stream and camera set-up into it); ``finish_fn(scene, state, *extras)``
    makes the caller's outputs from the final full-width state (for example
    path_mis.wavefront_finish and a splat).
    """

    def __init__(self, static, n, init_fn, finish_fn):
        self.static = static
        self.n = n
        self._init = init_fn
        self._finish = finish_fn
        self.widths = _default_widths(n)

    def _bounce(self, scene, spec, st_full, m, rr):
        """One bounce on the first ``m`` lanes of the full-width state;
        returns the full-width state and the alive count (a device
        scalar)."""
        if m == self.n:
            st = path_mis._bounce_ordered(scene, self.static, spec, st_full, draw_rr=rr)
            return st, st.alive.sum()
        st = path_mis._bounce_ordered(
            scene, self.static, spec, _slice_state(st_full, m), draw_rr=rr
        )
        return _concat_state(st, st_full), st.alive.sum()

    def _pick(self, count):
        for w in reversed(self.widths):
            if w >= count:
                return w
        return self.n

    def run(self, scene, spec, *args, widths=None):
        """One pass; returns (out, PassRecord).

        ``widths=None`` (sync mode): the host reads the alive count after
        each bounce and picks the next width; always exact.

        ``widths=[...]`` (pipelined mode): the per-bounce width schedule
        (for example ``record.plan()`` of an earlier pass), with no sync
        between bounces; the alive counts stay on the device in the record,
        and the caller must check ``record.ok()`` before trusting the
        output: a pass whose live prefix outgrew the schedule must be run
        again in sync mode. ``widths[0]`` must be the full lane width.
        """
        n = self.n
        # the alive-first prefix only exists where _bounce_ordered permutes
        # (multi-cluster scenes); elsewhere every bounce runs at full width
        narrow = path_mis._ordering_useful(scene)
        state, *extras = self._init(scene, *args)
        count = n
        depth = self.static.max_depth
        used, counts = [], []
        if widths is not None and (not narrow or widths[0] != n):
            widths = None if not narrow else [n] + list(widths[1:])
        for k in range(depth):
            if widths is None:
                if count == 0:
                    break
                m = self._pick(count) if narrow else n
            else:
                if k >= len(widths):
                    break
                m = widths[k]
            state, cnt = self._bounce(scene, spec, state, m, k >= 3)
            used.append(m)
            counts.append(cnt)
            # sync mode: the alive count picks the next width (not read on
            # the last bounce, nor when nothing narrows)
            if widths is None and narrow and k + 1 < depth:
                count = int(cnt)
                counts[-1] = count
        out = self._finish(scene, state, *extras)
        return out, PassRecord(self, used, counts, depth)


class PassRecord:
    """The widths used and the alive counts of one staged pass."""

    def __init__(self, sw, widths, counts, depth):
        self._sw = sw
        self.widths = widths
        self.counts = counts
        self.depth = depth

    def _ints(self):
        return [int(c) for c in self.counts]

    def ok(self):
        """Exactness check of a pipelined pass: each bounce's width covered
        the live prefix that entered it (the count after the bounce before),
        and a schedule that ended early ended with no live lane. A sync-mode
        pass meets this by construction. Reads the counts (a device sync)."""
        cs = self._ints()
        for k in range(1, len(self.widths)):
            if self.widths[k] < cs[k - 1]:
                return False
        if len(self.widths) < self.depth and cs and cs[-1] > 0:
            return False
        return True

    def plan(self, margin=1.25):
        """Width schedule for a later pass of similar content: each bounce
        gets the smallest menu width covering ``margin`` times the count
        that entered it here (counts move a little from pass to pass with
        the samples). The schedule stops at the first bounce that no lane
        entered alive here, so it may be shorter than the depth; ``ok``
        then fails a pass in which a lane lives past its end."""
        cs = self._ints()
        n = self._sw.n
        ws = [n]
        for k in range(1, self.depth):
            c = cs[k - 1] if k - 1 < len(cs) else 0
            if c == 0:
                break
            ws.append(self._sw._pick(min(n, int(c * margin))))
        return ws


def li_staged(scene, static, spec, stream, rays):
    """Drop-in staged counterpart of path_mis.li_wavefront (the same
    outputs); builds a one-shot driver. A render loop should hold a
    StagedWavefront across passes, so that each pass can take the schedule
    that ``plan()`` made from the one before."""
    n = rays.o.shape[0]

    def init_fn(scene_, stream_, rays_):
        return (path_mis.wavefront_init(scene_, static, spec, stream_, rays_),)

    def finish_fn(scene_, st):
        return path_mis.wavefront_finish(scene_, static, st)

    out, _ = StagedWavefront(static, n, init_fn, finish_fn).run(scene, spec, stream, rays)
    return out
