"""Training entry point: the step functions and the fault-tolerant loop.

The port of ``repro.launch.train``. ``make_grad_step`` builds the
(model, batch) → (grads, loss) function with microbatch gradient
accumulation: each microbatch's grads come from ``torch.autograd.grad``
and are added into ``cfg.accum_dtype`` (fp32) buffers, then divided by the
accumulation factor, as the reference's ``lax.scan`` does — ``.grad``
would accumulate in the bf16 param dtype. With ``grad_accum == 1`` the
grads keep the param dtype, as in the reference.

``Trainer`` wires every substrate together the way the paper intends its
extensions to be used: data prefetch + async checkpoints + heartbeats are
generalized requests completed by ONE progress engine; the checkpoint
stream (a ``cudaStream_t`` MPIX stream on the card: the snapshot copies
run there) gets its own progress thread; failures trigger the elastic
re-mesh plan, a windowed reshard of the latest checkpoint and
restore-from-latest. The model is one ``nn.Module`` whose parameters the
trainer turns ``requires_grad`` on for; the optimizer updates it in place.

Run: PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 20
(on the card; ``--device cpu`` for the plain path).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import iovec_store as store
from repro_torch.checkpoint.manager import WRITE_TIMEOUT_S, CheckpointManager
from repro_torch.core.progress import AutotunePolicy, ProgressEngine
from repro_torch.core.streams import stream_create, stream_free
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.ft.heartbeat import HeartbeatMonitor
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.models import api
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.convert import state_tree
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["make_grad_step", "make_train_step", "make_serve_step", "make_prefill_step", "Trainer"]


def make_grad_step(cfg: ModelConfig):
    """The backward half of the train step: (model, batch) → (grads, loss),
    grads a dict keyed like ``model.named_parameters()``, with the
    microbatch accumulation described in the module docstring."""

    def grad_step(model, batch):
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        names, ps = [n for n, _ in named], [p for _, p in named]
        accum = cfg.grad_accum
        if accum <= 1:
            loss, _metrics = api.loss_fn(cfg, model, batch)
            grads = torch.autograd.grad(loss, ps)
            return dict(zip(names, grads)), loss.detach()
        adt = torch_dtype(cfg.accum_dtype)
        micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:]) for k, v in batch.items()}
        gsum = {n: torch.zeros(p.shape, dtype=adt, device=p.device) for n, p in named}
        lsum = torch.zeros((), dtype=torch.float32, device=ps[0].device)
        for i in range(accum):
            loss, _metrics = api.loss_fn(cfg, model, {k: v[i] for k, v in micro.items()})
            for n, g in zip(names, torch.autograd.grad(loss, ps)):
                gsum[n].add_(g.to(adt))
            lsum = lsum + loss.detach()
        return {n: g / accum for n, g in gsum.items()}, lsum / accum

    return grad_step


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """(model, opt_state, batch) → (model, opt_state, metrics): the grad
    step followed by the in-place AdamW update."""
    grad_step = make_grad_step(cfg)

    def train_step(model, opt_state, batch):
        grads, loss = grad_step(model, batch)
        _, new_state, om = adamw_update(opt_cfg, grads, opt_state, dict(model.named_parameters()))
        return model, new_state, {"loss": loss, **om}

    return train_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens, pos):
        return api.decode_step(cfg, params, cache, tokens, pos)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return api.prefill(cfg, params, batch)

    return prefill_step


# ----------------------------------------------------------------------
# fault-tolerant training loop
# ----------------------------------------------------------------------


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: AdamWConfig,
        data_cfg: DataConfig,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50,
        ckpt_keep: int = 3,
        seed: int = 0,
        autotune: bool = True,
        autotune_policy: Optional[AutotunePolicy] = None,
        mesh_shape=(2, 16, 16),
        mesh_axes=("pod", "data", "model"),
        ranks=(0,),
        hb_timeout: float = 3600.0,
        hb_clock=None,
        hb_tick: float = 0.0,
        fault_injector=None,
        grad_overlap: str = "jit",
        grad_bucket_bytes: int = 1 << 16,
        grad_comms: int = 2,
        grad_window_depth: int = 2,
        device="cuda",
    ):
        self.cfg, self.opt_cfg, self.data_cfg = cfg, opt_cfg, data_cfg
        self.device = resolve_device(device)
        self.engine = ProgressEngine()
        # progress placement: the stats()-driven autotuner promotes the
        # streams that are actually hot (ckpt during save bursts, data
        # during prefetch) and demotes them between bursts; autotune=False
        # keeps the static hand placement for comparison
        self.autotune = autotune
        if autotune and autotune_policy is None:
            autotune_policy = AutotunePolicy(tune_spin=True)
        self.tuner = self.engine.autotune(autotune_policy) if autotune else None
        # the checkpoint stream binds a CUDA stream: the snapshot copies run
        # there, beside the training stream
        self.ckpt_stream = stream_create(info={"type": "cudaStream_t"}, name="ckpt")
        self.data_stream = stream_create(name="data")
        self._streams = [self.ckpt_stream, self.data_stream]
        self.pipeline = SyntheticPipeline(cfg, data_cfg, self.engine, self.data_stream)
        # the snapshots live in pinned host memory the manager keeps: at most
        # two saves in flight, so at most two snapshot buffers
        self.ckpt = (
            CheckpointManager(ckpt_dir, self.engine, self.ckpt_stream, keep=ckpt_keep, max_inflight=2)
            if ckpt_dir
            else None
        )
        self.ckpt_every = ckpt_every
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = api.init_params(cfg, gen, self.device)
        self.params.requires_grad_(True)
        self._named = dict(self.params.named_parameters())
        self.opt_state = adamw_init(opt_cfg, self._named)
        self._grad_fn = make_grad_step(cfg)
        # grad_overlap="windowed" drives the real backward through the
        # backward-overlapped bucketed allreduce: grad step → flatten →
        # bucketed_all_reduce_host(window=) with per-bucket RS admitted as
        # buckets are issued and AGs reaped in completion order → unflatten
        # → AdamW. Byte-identical to the fused "jit" step on the 1-rank
        # data axis (RS∘AG is the identity there; flatten→unflatten exact).
        if grad_overlap not in ("jit", "windowed"):
            raise ValueError(
                f"grad_overlap must be 'jit' or 'windowed', got {grad_overlap!r}"
            )
        self.grad_overlap = grad_overlap
        if grad_overlap == "windowed":
            from repro_torch.core.enqueue import OffloadWindow
            from repro_torch.core.mesh import make_mesh
            from repro_torch.core.streams import stream_comm_create
            from repro_torch.optim.grad_overlap import build_buckets

            mesh = make_mesh((1,), ("data",), device=self.device)
            grad_streams = [stream_create(name=f"grad{i}") for i in range(max(1, grad_comms))]
            win_stream = stream_create(name="grad-win")
            self._streams += grad_streams + [win_stream]
            self._grad_comms = [stream_comm_create(mesh, ("data",), s) for s in grad_streams]
            self._grad_window = OffloadWindow(
                win_stream,
                depth=grad_window_depth,
                engine=self.engine,
                name="grad-win",
            )
            self._grad_plan = build_buckets(list(self._named.values()), bucket_bytes=grad_bucket_bytes)
        self.start_step = 0
        # elastic state: the mesh the run believes in, the monitored rank
        # set, and the detect → replan → reshard → resume machinery. The
        # heartbeat's on_failure fires on the detector's polling thread,
        # so it only *notes* the failure; the training loop consumes the
        # note at the next step boundary (recover() rebuilds state there).
        self.mesh_shape = tuple(mesh_shape)
        self.mesh_axes = tuple(mesh_axes)
        self.mesh_plan = None
        self.ranks = list(ranks)
        self.fault_injector = fault_injector
        self._failure_lock = threading.Lock()
        self._pending_failures: list = []
        self.recoveries: list = []
        self.straggler = StragglerMonitor(ranks=self.ranks)
        # straggler mitigation is enacted, not just logged: run() feeds
        # advice through rebalance_shares into the pipeline's weighted
        # prefetch split (see _apply_straggler_advice)
        self.microbatch_total = max(len(self.ranks), int(getattr(cfg, "grad_accum", 1) or 1))
        self.microbatch_shares: Dict[int, int] = {}
        # named communication schedules riding this run: recover()
        # invalidates and re-records them on the new membership
        self.schedules: Dict[str, dict] = {}
        # hb_clock + hb_tick: a virtual clock the loop advances by hb_tick
        # per step makes detection latency a deterministic step count
        self.hb_clock = hb_clock
        self.hb_tick = hb_tick
        hb_kwargs = {} if hb_clock is None else {"clock": hb_clock}
        self.heartbeat = HeartbeatMonitor(
            ranks=self.ranks,
            timeout=hb_timeout,
            engine=self.engine,
            on_failure=self._note_failure,
            **hb_kwargs,
        )
        self.history = []
        self.step_seconds = []
        self.last_progress_stats: Optional[dict] = None

    # -- state ----------------------------------------------------------------
    def state_tree(self) -> dict:
        """The checkpointed state as the reference's tree over the live
        tensors: ``{"params": ..., "opt": {"m", "v", "master", "count"}}``."""
        opt = {k: state_tree(self.cfg, self.params, self.opt_state[k]) for k in ("m", "v", "master")
               if k in self.opt_state}
        opt["count"] = self.opt_state["count"]
        return {"params": state_tree(self.cfg, self.params, self._named), "opt": opt}

    def maybe_restore(self):
        if self.ckpt is None:
            return
        try:
            (state, step) = self.ckpt.restore_latest(self.state_tree())
        except FileNotFoundError:
            return
        self.ckpt.wait_snapshots()  # the copies below write saved tensors in place
        with torch.no_grad():
            for dst, src in zip(store.tree_tensors(self.state_tree()), store.tree_tensors(state)):
                dst.copy_(src)
        self.start_step = step + 1
        print(f"[trainer] restored step {step}")

    # -- fault-tolerance path ------------------------------------------------
    def handle_failure(self, failed_ranks, mesh_shape=(2, 16, 16), axes=("pod", "data", "model")):
        """Elastic recovery: plan a shrunken mesh (DP axes only) and roll
        back to the latest complete checkpoint. Returns the MeshPlan."""
        from repro_torch.ft.elastic import plan_remesh

        plan = plan_remesh(mesh_shape, axes, n_failed=len(failed_ranks))
        print(f"[trainer] failure of ranks {failed_ranks}: re-mesh -> {plan.shape} {plan.dropped}")
        self.maybe_restore()
        return plan

    def _note_failure(self, failed_ranks) -> None:
        """HeartbeatMonitor.on_failure target — runs on whichever thread
        drove the detector poll, so it must not touch the model; the
        training loop picks the note up at its next step boundary."""
        with self._failure_lock:
            self._pending_failures.extend(failed_ranks)

    def pending_failures(self) -> list:
        with self._failure_lock:
            return list(self._pending_failures)

    def _take_failures(self) -> list:
        with self._failure_lock:
            out, self._pending_failures = self._pending_failures, []
        return sorted(set(out))

    # -- straggler mitigation ------------------------------------------------
    def _apply_straggler_advice(self, advice) -> None:
        """Enact 'rebalance' advice: recompute inverse-speed microbatch
        shares and push them into the live pipeline's weighted prefetch
        split. Loader rank w serves mesh rank ``ranks[(w-1) % n]``."""
        if not any(a.action == "rebalance" for a in advice):
            return
        shares = self.straggler.rebalance_shares(self.microbatch_total)
        if not shares:
            return
        self.microbatch_shares = shares
        if self.pipeline.threadcomm is not None and self.ranks:
            weights = {
                w + 1: float(shares.get(self.ranks[w % len(self.ranks)], 1))
                for w in range(self.pipeline.n_workers)
            }
            self.pipeline.set_shares(weights)

    # -- recorded schedules across remesh ------------------------------------
    def register_schedule(self, name: str, schedule, record_fn: Callable) -> None:
        """Track a recorded communication schedule whose graph depends on
        the current membership. ``record_fn(schedule)`` must (re-)record it
        against the trainer's current mesh; recover() invalidates the
        schedule and calls it after every remesh."""
        self.schedules[name] = {"schedule": schedule, "record": record_fn, "rerecords": 0}

    def _rerecord_schedules(self, plan) -> list:
        done = []
        for name, ent in self.schedules.items():
            sch = ent["schedule"]
            if sch is not None and not getattr(sch, "recording", False):
                sch.invalidate(f"membership changed: re-mesh -> {plan.shape}")
            ent["record"](sch)
            ent["rerecords"] += 1
            done.append(name)
        return done

    def recover(self, failed_ranks, reshard_depth: int = 4):
        """The end-to-end elastic path: drop the dead ranks from the
        monitors, plan the shrunken mesh, stream the latest checkpoint's
        largest leaf through a depth-bounded reshard window onto the new
        data-parallel grid, and reload live state from the same files.
        Returns the MeshPlan; the reshard bytes + window stats land in
        ``self.recoveries[-1]``."""
        from repro_torch.ft.elastic import plan_remesh

        failed_ranks = sorted(set(failed_ranks))
        plan = plan_remesh(self.mesh_shape, self.mesh_axes, n_failed=len(failed_ranks))
        print(
            f"[trainer] failure of ranks {failed_ranks}: re-mesh "
            f"{self.mesh_shape} -> {plan.shape} {plan.dropped}"
        )
        for r in failed_ranks:
            self.straggler.drop_rank(r)
            self.heartbeat.remove_rank(r)
            if r in self.ranks:
                self.ranks.remove(r)
        # survivors keep fresh straggler slates on the new mesh
        for r in self.ranks:
            self.straggler.add_rank(r)
        shards, win_stats = None, None
        if self.ckpt is not None:
            # saves are async: settle them so "latest available step" is a
            # deterministic fact of the run, not of save-thread timing
            self._settle_saves()
        ckpt_step = None
        if self.ckpt is not None and self.ckpt.available_steps():
            ckpt_step = self.ckpt.available_steps()[-1]
            ckpt_dir = self.ckpt._dir_for(ckpt_step)
            shards, win_stats = self._reshard_checkpoint(ckpt_dir, plan, depth=reshard_depth)
            self.maybe_restore()
        self.mesh_shape = plan.shape
        self.mesh_plan = plan
        rerecorded = self._rerecord_schedules(plan)
        self.recoveries.append(
            {
                "failed": failed_ranks,
                "plan": plan,
                "ckpt_step": ckpt_step,
                "shards": shards,
                "reshard_stats": win_stats,
                "schedules_rerecorded": rerecorded,
            }
        )
        return plan

    def _reshard_checkpoint(self, ckpt_dir: str, plan, depth: int = 4):
        """Windowed reshard of the checkpoint's largest leaf against the
        new mesh's DP degree: the iovec store addresses the GLOBAL array,
        so the new shards are just different coalesced subarray reads
        over the same .bin files."""
        from repro_torch.ft.elastic import execute_reshard, reshard_plan

        with open(store.manifest_path(ckpt_dir)) as f:
            manifest = json.load(f)
        name, meta = max(
            manifest["leaves"].items(),
            key=lambda kv: int(np.prod(kv[1]["shape"] or [1])),
        )
        shape = tuple(meta["shape"]) or (1,)
        itemsize = np.dtype(meta["dtype"] if meta["dtype"] != "bfloat16" else "uint16").itemsize
        # DP degree on the new mesh, clipped to the largest divisor of the
        # leaf's leading dim (a grid must block-partition the array)
        dp = 1
        for ax in ("pod", "data"):
            if ax in plan.axis_names:
                dp *= plan.shape[plan.axis_names.index(ax)]
        g = max(d for d in range(1, min(dp, shape[0]) + 1) if shape[0] % d == 0)
        grid = (g,) + (1,) * (len(shape) - 1)
        plans = reshard_plan(shape, grid, itemsize)
        path = os.path.join(ckpt_dir, meta["file"])

        def read_run(iov):
            with open(path, "rb") as fh:
                fh.seek(iov.offset)
                return fh.read(iov.length)

        shards, stats = execute_reshard(
            plans, read_run, depth=depth, engine=self.engine, stream=self.ckpt_stream
        )
        return {"leaf": name, "grid": grid, "shards": shards}, stats

    # -- one step -------------------------------------------------------------
    def _update(self, grads, loss) -> Dict:
        """The in-place AdamW update, after the copies of the last save's
        snapshot: until here they ran beside this step's grad step."""
        if self.ckpt is not None:
            self.ckpt.wait_snapshots()
        _, self.opt_state, om = adamw_update(self.opt_cfg, grads, self.opt_state, self._named)
        return {"loss": loss, **om}

    def _windowed_step(self, batch) -> Dict:
        """One step on the windowed grad path: backward → flatten →
        per-bucket reduce-scatter admitted through the OffloadWindow
        (allgathers reaped in completion order) → unflatten → AdamW. The
        buckets' collectives are ordered after the backward's work on the
        current stream, so they need no materialize hook."""
        from repro_torch.optim.grad_overlap import (
            bucketed_all_reduce_host,
            flatten_grads,
            unflatten_grads,
        )

        grads, loss = self._grad_fn(self.params, batch)
        flat = flatten_grads(grads)
        reduced = bucketed_all_reduce_host(
            flat,
            self._grad_plan,
            self._grad_comms,
            engine=self.engine,
            window=self._grad_window,
        )
        return self._update(unflatten_grads(reduced, grads), loss)

    def step(self, batch) -> Dict:
        """One training step on ``batch`` (numpy or tensors) with the
        configured grad path; returns the metrics (tensors)."""
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        for k in ("img_embeds", "enc_frames"):
            if k in batch:
                batch[k] = batch[k].to(self.cfg.cdtype)
        if self.grad_overlap == "windowed":
            return self._windowed_step(batch)
        return self._update(*self._grad_fn(self.params, batch))

    def _settle_saves(self) -> None:
        if not self.ckpt.wait_for_pending(WRITE_TIMEOUT_S):
            raise TimeoutError(f"checkpoint writes not complete after {WRITE_TIMEOUT_S} s")

    def run(self, steps: int, log_every: int = 10):
        # background progress only where async work is actually in flight —
        # the paper's control knob (ext. 6), driven by stats() through the
        # autotuner; autotune=False keeps static placement on the two streams
        if self.tuner is not None:
            self.tuner.start()
        else:
            self.engine.start_progress_thread(self.ckpt_stream, interval=0.01)
            self.engine.start_progress_thread(self.data_stream, interval=0.0)
        # loader ranks are per-run epochs: re-open the threadcomm bracket
        # if a previous run() closed it
        if self.data_cfg.loader_threads > 0 and self.pipeline.threadcomm is None:
            self.pipeline.start_workers(self.data_cfg.loader_threads)
        try:
            self.pipeline.prefetch(self.start_step)
            for step in range(self.start_step, self.start_step + steps):
                # detect → replan → reshard → resume at the step boundary
                failed = self._take_failures()
                if failed:
                    self.recover(failed)
                t0 = time.perf_counter()
                self.pipeline.prefetch(step + 1)
                metrics = self.step(self.pipeline.get_batch(step))
                loss = float(metrics["loss"])  # waits for the step's device work
                dt_step = time.perf_counter() - t0
                self.step_seconds.append(dt_step)
                durations = {}
                for r in list(self.ranks):
                    d = dt_step
                    if self.fault_injector is not None:
                        # straggle faults report extra step seconds
                        d += self.fault_injector.stage_delay(r)
                    durations[r] = d
                self.straggler.record_step(durations)
                advice = self.straggler.check()
                if advice:
                    self._apply_straggler_advice(advice)
                for r in list(self.ranks):
                    self.heartbeat.record(r)
                if self.hb_clock is not None and self.hb_tick > 0:
                    self.hb_clock.advance(self.hb_tick)
                # one synchronous detector visit per step
                self.heartbeat.check()
                self.history.append(loss)
                if step % log_every == 0:
                    print(f"[trainer] step {step} loss {loss:.4f} ({dt_step*1e3:.0f} ms)")
                if self.ckpt and step > 0 and step % self.ckpt_every == 0:
                    self.ckpt.save_async(step, self.state_tree())
            if self.ckpt:
                final = self.start_step + steps - 1
                self.ckpt.save_async(final, self.state_tree())
                self._settle_saves()
        finally:
            # progress threads and loader ranks are per-run; the heartbeat
            # request stays live until close()
            self.pipeline.stop_workers()
            if self.tuner is not None:
                self.tuner.stop()
            self.engine.stop_all()
            st = self.engine.stats()
            self.last_progress_stats = st
            print(
                f"[trainer] progress engine: {st['completions']} completions, "
                f"{st['polls']} polls, {st['lock_waits']} lock waits, "
                f"{st['parks']} parks / {st['wakes']} wakes "
                f"({st['spin_hits']} spin hits)"
            )
            if self.tuner is not None:
                ts = self.tuner.stats()
                print(
                    f"[trainer] autotuner: {ts['ticks']} ticks, "
                    f"{ts['promotions']} promotions / {ts['demotions']} demotions, "
                    f"spin_s {ts['spin_s']*1e6:.0f}us "
                    f"({ts['spin_grows']} grows / {ts['spin_shrinks']} shrinks)"
                )
        return self.history

    def close(self) -> None:
        """Release what the trainer holds beyond a run: the heartbeat
        detector, the progress threads and its MPIX streams' channels."""
        self.heartbeat.stop()
        self.engine.stop_all()
        for s in self._streams:
            stream_free(s)
        self._streams = []


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config

    cfg = get_config(args.arch, smoke=args.smoke)
    tr = Trainer(
        cfg,
        AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=args.steps),
        DataConfig(batch=args.batch, seq=args.seq),
        ckpt_dir=args.ckpt_dir,
        device=args.device,
    )
    try:
        tr.maybe_restore()
        hist = tr.run(args.steps)
    finally:
        tr.close()
    print(f"[trainer] loss {hist[0]:.4f} -> {hist[-1]:.4f}")
    return hist


if __name__ == "__main__":
    main()
