"""SimService — fixed-slot multi-tenant LBM session manager.

The port of ``repro.sim.service``.  Sessions are packed into FIXED
ensemble slots per (geometry, config) group, so the batched step shape
never changes; a freed slot is refilled from the queue at the next
admission opportunity.  Per group, all occupied slots advance together
(:class:`repro_torch.sim.ensemble.EnsembleLBM`: on ``fused`` one launch of
K1 over every slot's tiles), which is what amortises the sparse
indirection tables across tenants.

Sessions carry a step budget (``max_steps``); on completion the service
collects a compact result — per-session mass, probe readouts (rho, u at
dense grid points) and mean speed — and frees the slot.

Checkpoint/resume rides on
:class:`repro_torch.checkpoint.store.CheckpointStore`, in the JAX package's
format (manifest + raw-byte shards + COMMITTED marker): every live
session's canonical (Q, T, n) state plus each DISTINCT geometry (stored
once, keyed by content fingerprint) are saved as checkpoint trees, the
bookkeeping (budgets, probes, config dicts, initial masses) as manifest
``extra``.  ``SimService.restore`` re-queues every
session with its saved state, so the next admission seats it exactly where
it left off — and a torn save (no COMMITTED) is skipped by
``CheckpointStore.latest``.  A checkpoint written by either package
restores in the other.

The service runs on the registry's device (None: the card).  The step
path does not wait for the card: a finish queues its reductions (mass,
speeds, probe values) on the device and the service reads every pending
result in one copy when ``step()`` or ``run()`` returns, or in
``collect()`` and ``checkpoint()``.  It waits only where metrics are on
(the window gauge reads the wall clock, and each finish reads its drift
for its gauge and event), when it builds a group's ensemble, and when it
seats a restored session (its saved state is copied to the card).
"""
from __future__ import annotations

import dataclasses
import time

import warnings

import numpy as np
import torch

from .. import obs
from ..checkpoint.store import CheckpointStore, host_copy
from ..core.engine import LBMConfig
from ..core.tiling import Tiling, untile

from .registry import (EngineRegistry, config_from_dict, config_signature,
                       config_to_dict)


def probe_indices(tiling: Tiling, points) -> tuple[np.ndarray, np.ndarray]:
    """Dense grid coordinates -> (tile index, node slot) pairs.

    Raises if a probe lands outside the grid or inside a dropped
    (all-solid) tile — a probe that can never read fluid is a user error
    worth failing loudly on at submit time, not at collect time.
    """
    pts = np.atleast_2d(np.asarray(points, np.int64))
    if pts.shape[1] != 3:
        raise ValueError(f"probes must be (P, 3) grid points, got {pts.shape}")
    # bounds-check against the ORIGINAL extent: tiling.shape is padded up
    # to tile multiples with SOLID filler a user probe must never read
    if (pts < 0).any() or (pts >= np.array(tiling.orig_shape)).any():
        raise ValueError(f"probe out of grid {tiling.orig_shape}: {pts}")
    a = tiling.a
    tc = pts // a
    tidx = tiling.tile_map[tc[:, 0], tc[:, 1], tc[:, 2]]
    if (tidx < 0).any():
        raise ValueError(f"probe inside an empty (all-solid) tile: "
                         f"{pts[tidx < 0]}")
    off = pts - tc * a
    canon = off[:, 0] + a * off[:, 1] + a * a * off[:, 2]
    return tidx.astype(np.int64), tiling.node_perm[canon]


@dataclasses.dataclass
class SimSession:
    """One tenant: a flow state with a step budget and probe points."""

    sid: int
    geometry: np.ndarray
    cfg: LBMConfig
    max_steps: int
    probes: tuple = ()                 # ((x, y, z), ...) dense grid points
    collect_fields: bool = False       # attach dense (rho, u) to the result
    steps_done: int = 0
    done: bool = False
    result: dict | None = None
    # service-step index at submit time; queue-wait = seated_at - submitted_at
    submitted_at: int = 0
    # recorded at first seating: a 0-d device tensor until the service
    # reads its results, then a float
    mass0: float | torch.Tensor | None = None
    # canonical (Q, T, n) state to seat with (checkpoint restore); None
    # seats a fresh equilibrium state
    restore_f: np.ndarray | None = None
    # cached registry key — geometry hashing is O(grid) and must not run
    # once per queue poll (derived; recomputed after a checkpoint restore)
    engine_key: tuple | None = dataclasses.field(default=None, repr=False)
    # probe (tile, slot) index tensors on the device, made off the step path
    # (at submit and restore) so that a finish copies nothing to the card
    probe_at: tuple | None = dataclasses.field(default=None, repr=False)
    # a finished session's device tensors not yet read into ``result``
    pending: dict | None = dataclasses.field(default=None, repr=False)


class _Group:
    """All sessions sharing one registry entry: a fixed-slot ensemble.

    The ensemble (live flow state) is built PER GROUP from the entry's
    shared engine — the registry shares tables across services, never
    mutable state.
    """

    def __init__(self, entry, slots: int):
        self.entry = entry
        self.ensemble = entry.engine.ensemble(slots)
        self.active: list[SimSession | None] = [None] * slots

    @property
    def occupied(self) -> list[int]:
        return [i for i, s in enumerate(self.active) if s is not None]


class SimService:
    def __init__(self, slots: int = 4, registry: EngineRegistry | None = None,
                 checkpoint_root: str | None = None, keep: int = 3,
                 device=None):
        """Engines live on ``registry.device``; without a registry, on
        ``device`` (None: the card)."""
        self.slots = slots
        self.registry = (registry if registry is not None
                         else EngineRegistry(device))
        self.groups: dict[tuple, _Group] = {}
        self.queue: list[SimSession] = []
        self.finished: list[SimSession] = []
        self._unread: list[SimSession] = []     # finished, results on device
        self.store = (CheckpointStore(checkpoint_root, keep=keep)
                      if checkpoint_root else None)
        self._next_sid = 0
        self._service_steps = 0        # admission clock for queue-wait obs
        # resume numbering above any existing save: restarting at 0 in a
        # reused root would make the store's keep-newest gc delete the new
        # run's checkpoints and leave restore() resuming the stale run
        last = self.store.latest() if self.store else None
        self._ckpt_step = 0 if last is None else last + 1

    # ------------------------------------------------------------------ api
    def submit(self, geometry: np.ndarray, cfg: LBMConfig, steps: int,
               probes=(), collect_fields: bool = False) -> int:
        """Queue a session; returns its sid.  Probes are validated against
        the geometry's tiling up front (building the engine on first use
        of the (geometry, config) key).  ``collect_fields`` attaches the
        dense macroscopic (rho, u) grids to the finish result."""
        if int(steps) < 1:
            raise ValueError(f"step budget must be >= 1 (got {steps}) — a "
                             "0-step session would still be seated and "
                             "stepped once")
        sid = self._next_sid
        self._next_sid += 1
        # own copy: the content hash is taken lazily and the array is
        # checkpointed later, so aliasing the caller's buffer would let an
        # in-place mutation corrupt the key and the saved geometry
        geometry = np.array(geometry, np.uint8, copy=True, order="C")
        probes = tuple(tuple(int(c) for c in p) for p in probes)
        sess = SimSession(sid=sid, geometry=geometry, cfg=cfg,
                          max_steps=int(steps), probes=probes,
                          collect_fields=collect_fields,
                          submitted_at=self._service_steps)
        # validation: raises on a probe that can never read fluid
        self._place_probes(sess)
        self.queue.append(sess)
        reg = obs.get_metrics()
        if reg.enabled:
            reg.counter("sim.session.submitted_total").inc()
            reg.event("sim.session.submit", sid=sid, steps=int(steps))
        return sid

    def _place_probes(self, sess: SimSession) -> None:
        """The session's probe indices, on the device.  get() is a pure
        lookup, so this never skews the seated-session hit count."""
        if sess.probes:
            entry = self.registry.get(sess.geometry, sess.cfg)
            sess.probe_at = tuple(
                torch.as_tensor(i, device=self.registry.device)
                for i in probe_indices(entry.engine.tiling, sess.probes))

    def _session_key(self, sess: SimSession) -> tuple:
        if sess.engine_key is None:
            sess.engine_key = self.registry.key_for(sess.geometry, sess.cfg)
        return sess.engine_key

    def _admit(self) -> None:
        """Seat queued sessions into free slots (fixed-slot refill)."""
        reg = obs.get_metrics()
        still = []
        for sess in self.queue:
            key = self._session_key(sess)
            group = self.groups.get(key)
            if group is None:
                entry = self.registry.get(sess.geometry, sess.cfg)
                group = self.groups[key] = _Group(entry, self.slots)
                if reg.enabled:
                    # the group's modelled traffic numbers (bandwidth
                    # fraction et al.) under the canonical names, labelled
                    # by the geometry fingerprint prefix
                    for name, v in entry.engine.model_metrics().items():
                        reg.gauge(name, group=key[0][:8]).set(v)
            free = [i for i, s in enumerate(group.active) if s is None]
            if not free:
                still.append(sess)
                continue
            group.entry.hits += 1              # one hit per seated session
            slot = free[0]
            if sess.restore_f is not None:
                group.ensemble.set_replica(slot, sess.restore_f)
                sess.restore_f = None
            else:
                group.ensemble.reset(slot)
            group.active[slot] = sess
            if sess.mass0 is None:
                sess.mass0 = group.ensemble.replica_mass_tensor(slot)
            if reg.enabled:
                reg.counter("sim.session.admitted_total").inc()
                reg.histogram("sim.session.queue_wait_steps").observe(
                    self._service_steps - sess.submitted_at)
                reg.event("sim.session.admit", sid=sess.sid, slot=slot,
                          group=key[0][:8],
                          waited=self._service_steps - sess.submitted_at)
        self.queue = still

    def step(self, steps: int = 1) -> bool:
        """Advance every occupied group by ``steps`` LBM iterations (one
        batched step per group per iteration), finishing sessions that
        exhaust their budget and refilling their slots from the queue.
        The results of the sessions that finished are read on return.

        Returns False when there is nothing left to do.
        """
        more = self._step(steps)
        self._read_results()
        return more

    def _step(self, steps: int) -> bool:
        reg = obs.get_metrics()
        tr = obs.get_tracer()
        progressed = False
        updates = 0
        stepped: set = set()
        t0 = time.perf_counter()
        with tr.span("sim.service.step", steps=steps):
            for _ in range(steps):
                self._admit()
                self._service_steps += 1
                any_active = False
                for key, group in self.groups.items():
                    occ = group.occupied
                    if not occ:
                        continue
                    any_active = True
                    with tr.span("sim.group.step", group=key[0][:8],
                                 occupied=len(occ)):
                        group.ensemble.step(1)
                    if reg.enabled:
                        stepped.add(key)
                        updates += len(occ) * group.ensemble.n_fluid_nodes
                    for slot in occ:
                        sess = group.active[slot]
                        sess.steps_done += 1
                        if reg.enabled:
                            reg.counter("sim.session.steps_total",
                                        sid=sess.sid).inc()
                        if sess.steps_done >= sess.max_steps:
                            self._finish(group, slot)
                progressed |= any_active
                if not any_active and not self.queue:
                    break
        if reg.enabled:
            # sync before reading the clock: the launches above are
            # asynchronous, so the window MFLUPS must wait for the card.
            # The disabled path never synchronises.
            if stepped and self.registry.device.type == "cuda":
                torch.cuda.synchronize(self.registry.device)
            wall = time.perf_counter() - t0
            for key, group in self.groups.items():
                reg.gauge("sim.slot.occupancy", group=key[0][:8]).set(
                    len(group.occupied) / max(1, len(group.active)))
            if updates:
                reg.counter("sim.node_updates_total").inc(updates)
                if wall > 0:
                    reg.gauge("sim.service.window_mflups").set(
                        updates / wall / 1e6)
        return progressed or bool(self.queue)

    def run(self, max_steps: int | None = None,
            checkpoint_every: int = 0) -> list[SimSession]:
        """Step until every submitted session finishes.

        Budgets are finite, so the loop always terminates; ``max_steps``
        optionally caps this call's iterations — hitting the cap leaves
        the remaining sessions seated/queued (resumable by another
        ``run``/``step`` or a checkpoint) and WARNS rather than silently
        dropping them.
        """
        n = 0
        while (max_steps is None or n < max_steps) and self._step(1):
            n += 1
            if checkpoint_every and self.store and n % checkpoint_every == 0:
                self.checkpoint()
        self._read_results()
        live_sids = sorted(
            [s.sid for g in self.groups.values() for s in g.active if s]
            + [s.sid for s in self.queue])
        if live_sids:
            warnings.warn(
                f"SimService.run stopped at max_steps={max_steps} with "
                f"{len(live_sids)} session(s) unfinished (sids {live_sids});"
                " they remain live — call run()/step() again or "
                "checkpoint() to persist them",
                RuntimeWarning, stacklevel=2)
        return self.finished

    def collect(self, sid: int) -> dict | None:
        """Result of a finished session (None while still running)."""
        self._read_results()
        for sess in self.finished:
            if sess.sid == sid:
                return sess.result
        return None

    def release_idle(self) -> int:
        """Free groups with no seated sessions, returning how many.

        Each group pins a slots-wide ensemble state on device; a
        long-lived service cycling through many (geometry, config) keys
        should release idle ones between tenant waves.  The registry's
        engine (host and device tables) stays cached, so a later session
        on the same key re-seats without re-tiling.
        """
        keyed = {self._session_key(s) for s in self.queue}
        idle = [k for k, g in self.groups.items()
                if not g.occupied and k not in keyed]
        for k in idle:
            del self.groups[k]
        return len(idle)

    # ------------------------------------------------------------- internals
    def _finish(self, group: _Group, slot: int) -> None:
        """Queue a finished session's reductions on the device and free its
        slot.  Only scalars, probe values and (when asked for) the dense
        fields come to the host, in :meth:`_read_results`."""
        sess = group.active[slot]
        ens = group.ensemble
        rho, u = ens.macroscopics(slot)
        speed = (u * u).sum(dim=0).sqrt().flatten()[ens.fluid_index]
        pending = {"mass": ens.replica_mass_tensor(slot)}
        if speed.numel():
            pending.update(mean_speed=speed.mean(), max_speed=speed.max())
        if sess.probes:
            ti, si = sess.probe_at
            pending.update(p_rho=rho[ti, si], p_u=u[:, ti, si].T)
        if sess.collect_fields:
            pending["fields"] = (ens.tiling, rho, u)
        sess.pending = pending
        sess.result = {"sid": sess.sid, "steps": sess.steps_done}
        sess.done = True
        self.finished.append(sess)
        self._unread.append(sess)
        group.active[slot] = None
        reg = obs.get_metrics()
        if reg.enabled:
            self._read_results()
            reg.counter("sim.session.finished_total").inc()
            reg.gauge("lbm.mass.drift", sid=sess.sid).set(
                sess.result["mass_drift"])
            reg.event("sim.session.finish", sid=sess.sid,
                      steps=sess.steps_done,
                      mass_drift=sess.result["mass_drift"])

    def _read_results(self) -> None:
        """Fill in the results of every finished session whose reductions
        are still on the device: their scalars and probe values come over
        in one copy (float64 holds every float32 value exactly)."""
        if not self._unread:
            return
        parts = []
        for sess in self._unread:
            p = sess.pending
            parts += [p[k].reshape(-1) for k in
                      ("mass", "mean_speed", "max_speed", "p_rho", "p_u")
                      if k in p]
            if torch.is_tensor(sess.mass0):
                parts.append(sess.mass0.reshape(-1))
        host = iter(torch.cat([x.to(torch.float64) for x in parts]).tolist())
        for sess in self._unread:
            p = sess.pending
            mass = next(host)
            speeds = ((next(host), next(host)) if "mean_speed" in p
                      else (0.0, 0.0))
            probes = None
            if "p_rho" in p:
                n, dim = p["p_u"].shape
                p_rho = [next(host) for _ in range(n)]
                p_u = [[next(host) for _ in range(dim)] for _ in range(n)]
                probes = [{"point": list(pt), "rho": r, "u": v}
                          for pt, r, v in zip(sess.probes, p_rho, p_u)]
            if torch.is_tensor(sess.mass0):
                sess.mass0 = next(host)
            sess.result.update({
                "mass": mass,
                "mass0": sess.mass0,
                "mass_drift": abs(mass - sess.mass0) / abs(sess.mass0)
                if sess.mass0 else 0.0,
                "mean_speed": speeds[0],
                "max_speed": speeds[1],
            })
            if probes is not None:
                sess.result["probes"] = probes
            if "fields" in p:
                tiling, rho, u = p["fields"]
                sess.result["rho_dense"] = untile(tiling, host_copy(rho),
                                                  fill=np.nan)
                sess.result["u_dense"] = untile(tiling, host_copy(u), fill=0.0)
            sess.pending = None
        self._unread = []

    # ------------------------------------------------------------ checkpoint
    def live_sessions(self) -> list[tuple[SimSession, np.ndarray | None]]:
        """Every unfinished session with its canonical state (None for a
        queued session that has never been seated)."""
        out = []
        for group in self.groups.values():
            for slot in group.occupied:
                out.append((group.active[slot],
                            host_copy(group.ensemble.replica_canonical(slot))))
        for sess in self.queue:
            out.append((sess, sess.restore_f))
        return sorted(out, key=lambda p: p[0].sid)

    def checkpoint(self) -> str:
        """Atomically save every live session AND every finished-but-
        uncollected result through CheckpointStore.

        Sessions reference their geometry by content fingerprint, so N
        tenants on one geometry store it ONCE per save instead of N times
        (the same dedup key the registry compiles under).  Finished
        results ride in the manifest ``extra`` (dense field arrays, when
        requested, as their own tree), so a restart after a session
        completes but before the operator collects it loses nothing.
        """
        if self.store is None:
            raise ValueError("construct with checkpoint_root= to checkpoint")
        self._read_results()
        trees, metas, geoms = {}, [], {}
        for sess, f in self.live_sessions():
            fp = self._session_key(sess)[0]      # geometry fingerprint
            geoms.setdefault(fp, sess.geometry)
            if f is not None:
                trees[f"s{sess.sid}"] = {"f": f}
            metas.append({
                "sid": sess.sid,
                "steps_done": sess.steps_done,
                "max_steps": sess.max_steps,
                "probes": [list(p) for p in sess.probes],
                "collect_fields": sess.collect_fields,
                "mass0": (float(sess.mass0) if torch.is_tensor(sess.mass0)
                          else sess.mass0),
                "has_state": f is not None,
                "geometry_fp": fp,
                "cfg": config_to_dict(sess.cfg),
            })
        finished_metas = []
        for sess in self.finished:
            scalars = {k: v for k, v in sess.result.items()
                       if not isinstance(v, np.ndarray)}
            dense = {k: v for k, v in sess.result.items()
                     if isinstance(v, np.ndarray)}
            if dense:
                trees[f"r{sess.sid}"] = dense
            finished_metas.append({"sid": sess.sid,
                                   "steps_done": sess.steps_done,
                                   "max_steps": sess.max_steps,
                                   "result": scalars})
        trees["geometries"] = geoms
        extra = {"sessions": metas, "finished": finished_metas,
                 "next_sid": self._next_sid, "ckpt_step": self._ckpt_step}
        path = self.store.save(self._ckpt_step, trees, extra)
        self._ckpt_step += 1
        return path

    @classmethod
    def restore(cls, checkpoint_root: str, slots: int = 4,
                registry: EngineRegistry | None = None,
                step: int | None = None, keep: int = 3,
                device=None) -> "SimService":
        """Rebuild a service from the latest COMMITTED checkpoint (written
        by this package or by the JAX package); engines on ``device`` as in
        the constructor.

        Every saved session is re-queued with its saved state; the next
        ``step()`` seats it into a slot exactly where it left off.  Torn
        saves (no COMMITTED marker) are ignored by ``latest()``.
        """
        store = CheckpointStore(checkpoint_root, keep=keep)
        if step is None:
            step = store.latest()
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {checkpoint_root}")
        trees, extra = store.restore_trees(step)

        svc = cls(slots=slots, registry=registry,
                  checkpoint_root=checkpoint_root, keep=keep, device=device)
        svc._next_sid = extra["next_sid"]
        svc._ckpt_step = extra["ckpt_step"] + 1
        geoms = trees["geometries"]
        for meta in extra["sessions"]:
            fp = meta["geometry_fp"]
            cfg = config_from_dict(meta["cfg"])
            tree = trees.get(f"s{meta['sid']}", {})
            sess = SimSession(
                sid=meta["sid"],
                geometry=np.asarray(geoms[fp], np.uint8),
                cfg=cfg,
                max_steps=meta["max_steps"],
                probes=tuple(tuple(p) for p in meta["probes"]),
                collect_fields=meta.get("collect_fields", False),
                steps_done=meta["steps_done"],
                mass0=meta["mass0"],
                restore_f=tree.get("f") if meta["has_state"] else None,
                # the saved fingerprint + this package's config signature
                # skip re-hashing the geometry on the first poll
                engine_key=(fp, config_signature(cfg)),
            )
            svc._place_probes(sess)
            svc.queue.append(sess)
        for meta in extra.get("finished", []):
            result = dict(meta["result"])
            result.update(trees.get(f"r{meta['sid']}", {}))  # dense fields
            # result-only stub: never re-queued (done=True), exists so
            # collect(sid) keeps working across the restart
            svc.finished.append(SimSession(
                sid=meta["sid"], geometry=np.zeros((0, 0, 0), np.uint8),
                cfg=None, max_steps=meta["max_steps"],
                steps_done=meta["steps_done"], done=True, result=result))
        return svc
