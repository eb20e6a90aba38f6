"""Static-batch baseline: what continuous batching is measured against.

Port of ``repro/serve/baseline.py``.  ``static_batch_serve`` is the
conventional batched-driver discipline: pack the next ``slots`` queued
requests into one batch, run that batch until its *last* slot finishes, only
then admit the next wave.  Converged lanes idle while stragglers run out,
the head-of-line blocking that slot recycling in
:class:`~repro_torch.serve.server.RecoveryServer` removes.  Both share the
same :class:`~repro_torch.serve.engine.BatchEngine`, clocks and request
stream, so the difference is the scheduling discipline alone.
"""

from __future__ import annotations

from typing import List, Optional

from .request import Clock, RecoveryResult, WallClock
from .server import RecoveryServer, mesh_now


def static_batch_serve(
    requests,
    mesh=None,
    slots: int = 8,
    round_iters: int = 32,
    clock: Optional[Clock] = None,
    server: Optional[RecoveryServer] = None,
    **engine_kw,
) -> List[RecoveryResult]:
    """Serve ``requests`` in fixed waves of ``slots`` (no recycling).

    Requests are taken in arrival order; each wave runs to completion
    (every lane inactive) before the next wave is admitted.  Deadlines are
    still honoured (an expired lane is harvested as a flagged partial), but
    a freed lane stays empty until the wave drains.

    ``server`` optionally supplies a built (e.g. ``warmup``-ed)
    :class:`RecoveryServer` whose bucketing and engine cache are reused, so
    the baseline and the continuous path share their engines (and, on the
    card, their captured rounds).  On a mesh every clock read is rank 0's
    (:func:`~repro_torch.serve.server.mesh_now`).
    """
    keyer = server if server is not None else RecoveryServer(
        mesh=mesh, slots=slots, round_iters=round_iters, **engine_kw
    )
    clock = clock if clock is not None else (
        keyer.clock if server is not None else WallClock()
    )
    now = lambda: mesh_now(clock, keyer.mesh)
    slots = keyer.slots
    results: List[RecoveryResult] = []
    pending = sorted(requests, key=lambda r: r.arrival_time)
    if not pending:
        return results

    engines = {}

    i = 0
    while i < len(pending):
        req = pending[i]
        key = keyer.bucket_key(req)
        eng = engines.get(key)
        if eng is None:
            eng = keyer._engine_for(key, req)
            engines[key] = eng
        # fill a wave from consecutive same-bucket requests
        wave = []
        while i < len(pending) and len(wave) < slots \
                and keyer.bucket_key(pending[i]) == key:
            wave.append(pending[i])
            i += 1
        clock.advance_to(wave[-1].arrival_time)
        t = now()
        for slot, r in enumerate(wave):
            eng.admit(slot, r, t)
        while eng.busy:
            eng.run_round()
            results.extend(eng.harvest(now()))
    return results
