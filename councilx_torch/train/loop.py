"""The outer training loop (reference train.py), on one device or one
process per GPU.

Counterpart of ``councilx/train/loop.py``: fetch an unpaired batch pair,
step, then log, sample and snapshot on the configured cadences. In the
port:

* the host loader decodes uint8 batches (``data/loader.py``); with
  ``cfg.host_prefetch`` one worker thread stages step k+1 while step k runs:
  it takes the next batches, draws their crops and flips
  (``data/ondevice.py::draw_crops``, keyed by the absolute step and the
  global row) and pins them. It makes no other CUDA call: the main thread
  issues the non-blocking host-to-device copies and the augment;
* on a card the step of every trainer runs as captured CUDA graphs
  (``CouncilTrainer.compile_step``), the counterpart of the JAX loop's
  ``_jit_step``: the loop's first step of each shape runs eagerly as the
  warm-up, the next is captured, and every later one replays. The
  multi-process trainers (``parallel/``) capture their NCCL collectives
  with the step; their snapshots and sample sheets stay eager collectives
  between the replays, issued by every rank at the same steps. A CPU
  device steps eagerly; the run prints which route it took;
* the metrics stay on the device between log points; at each ``log_iter``
  they are stacked and read back with one copy;
* snapshots (``ckpt/manager.py``) copy the state to the host before the
  loop goes on and write the file in a background thread; the final one is
  written at the end, or at a stop request (``stop_event``);
* ``profile_steps`` wraps those steps in a ``torch.profiler`` trace under
  ``<run>/profile``;
* ``cfg.eval_iter > 0`` scores the council's translations of the test
  split with FID every ``eval_iter`` steps (``eval/hook.py``), logged as
  ``fid_<direction>`` after the step's metrics and before the sample
  sheets, as the JAX loop does.

A resumed run restores the parameters, the Adam moments and counts, the
step and the z generator, fast-forwards the loaders by the step
(``start_batch``) and keys the augment by the absolute step, so it goes on
bit for bit as the uninterrupted run would.

Multi-GPU: one process per GPU runs this function (torchrun, or
``cli/train.py``'s ``--coordinator/--num_processes/--process_id``), with
``cfg.num_devices`` the world size and ``cfg.council_parallel`` the council
axis (:func:`make_trainer`). Each rank loads its data shard's rows (the
ranks of one shard load the same rows) and crops them by their global row;
the display batches are rank 0's; the resume step is agreed before any rank
restores; the sample sheets are drawn on every rank (a collective under
member parallelism), and the logs, sheets, HTML and snapshot files are
rank 0's. ``stop_event`` is honoured at one process only, as in the JAX
loop: one rank leaving early would strand the others in a collective.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import torch
import yaml

from councilx_torch.ckpt.manager import (SNAPSHOT_FILE, latest_checkpoint,
                                         restore_checkpoint, save_checkpoint,
                                         wait_for_checkpoints)
from councilx_torch.config import Config
from councilx_torch.data.loader import get_all_data_loaders
from councilx_torch.data.ondevice import augment_batch, draw_crops, row_seed
from councilx_torch.eval.hook import TrainEvalHook
from councilx_torch.parallel import multihost
from councilx_torch.parallel.council_shard import CouncilShardTrainer
from councilx_torch.parallel.mesh import DataParallelTrainer, make_mesh
from councilx_torch.train.trainer import CouncilTrainer
from councilx_torch.utils import graphs as cuda_graphs
from councilx_torch.utils.images import write_html, write_sample_sheet
from councilx_torch.utils.logging import MetricLogger, prepare_sub_folder

# the draw streams of one step: domain A's crops, domain B's, sample z
_STREAM_A, _STREAM_B, _STREAM_SAMPLE = 0, 1, 7


def make_trainer(cfg: Config, device="cuda") -> CouncilTrainer:
    """The trainer for ``cfg`` on this process's ``device``, as the JAX
    package routes it: ``num_devices == 1`` -> :class:`CouncilTrainer`;
    more -> one process per GPU over the world's process group, the
    data-parallel trainer, or with ``council_parallel > 1`` the
    member-sharded one. ``det_data_reduction`` needs the shard trainer's
    explicit reduction, so pure data parallelism takes it with a council
    axis of 1. ``num_devices`` must be the world size: one process asked
    for more refuses."""
    world = multihost.process_count()
    if max(1, cfg.num_devices) != world:
        raise ValueError(
            f"num_devices={cfg.num_devices} (council_parallel="
            f"{cfg.council_parallel}, det_data_reduction="
            f"{cfg.det_data_reduction}) trains one process per GPU, and "
            f"this run has {world}: launch num_devices processes with "
            f"torchrun --nproc_per_node={cfg.num_devices} -m "
            "councilx_torch.cli.train (or --coordinator/--num_processes/"
            "--process_id), or set num_devices to the world size")
    if cfg.num_devices <= 1:
        return CouncilTrainer(cfg, device=device)
    if cfg.council_parallel > 1 or cfg.det_data_reduction:
        return CouncilShardTrainer(
            cfg, make_mesh(cfg.num_devices, cfg.council_parallel,
                           always_2d=True), device=device)
    return DataParallelTrainer(cfg, make_mesh(cfg.num_devices),
                               device=device)


def mask_skipped_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    """Drop the placeholders of steps whose gated council-discriminator
    update did not run (``cdis_ratio_mode="every_kth"``), so that the log
    has no point for them rather than a fake 0; consumes the
    ``cdis_updated`` flag either way."""
    updated = metrics.pop("cdis_updated", None)
    if updated is not None and updated == 0.0:
        metrics.pop("loss_dis_council", None)
        metrics.pop("finite_cdis", None)
    return metrics


def _host_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The step's 0-d device metrics as host floats, in one copy."""
    if not metrics:
        return {}
    vals = torch.stack([v.detach().float().reshape(())
                        for v in metrics.values()]).cpu().tolist()
    return dict(zip(metrics, vals))


def train(cfg: Config, output_path: str = "outputs", run_name: str = "run",
          resume: bool = False, synthetic: bool = False,
          max_steps: Optional[int] = None, seed: int = 0,
          profile_steps: Optional[range] = None, stop_event=None,
          device="cuda") -> Dict:
    """Train on ``device`` (the card unless the caller asks for another)
    into ``<output_path>/<run_name>``. Returns a summary: the final step,
    the step resumed from, the last log window's img/s, whether a stop
    request ended it, whether the train loaders decoded natively, the
    seconds the loop waited for staged batches, and of the snapshots: the
    seconds each one saved during the run held the loop for its
    device-to-host copy, the seconds the loop waited for their writes, the
    seconds of the final (synchronous) save, and the size on disk.

    ``stop_event`` (a ``threading.Event``): once set, the loop finishes the
    current step, writes a final snapshot and returns with
    ``interrupted=True``. Ignored when more than one process trains.

    The step runs as captured CUDA graphs on a card, whatever the
    trainer, and eagerly on a CPU device the caller asked for: the
    summary's ``graphs``, and the seconds each capture took in
    ``capture_seconds``.

    Multi-process: every rank calls this (see the module docstring); the
    summary's ``snapshot_bytes`` is rank 0's alone (None elsewhere)."""
    n_proc = multihost.process_count()
    primary = multihost.is_primary()
    trainer = make_trainer(cfg, device)
    dev = trainer.device
    run_dir = os.path.join(output_path, run_name)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    image_dir = os.path.join(run_dir, "images")
    if primary:
        prepare_sub_folder(run_dir)
        with open(os.path.join(run_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(cfg.to_dict(), f)

    start_step = 0
    state = None
    if resume:
        # agree before any rank restores: each resolves --resume on its own
        # file system, and a rank that restores while another initializes
        # would desynchronize every later collective
        found = latest_checkpoint(ckpt_dir)
        steps = multihost.allgather_int(found[0] if found else -1)
        if min(steps) != max(steps):
            raise RuntimeError(
                f"resume desynchronized across ranks: latest snapshot steps "
                f"{steps}; snapshots must live on a shared file system (or "
                "be mirrored to every host)")
        if steps[0] >= 0:
            payload, start_step = restore_checkpoint(ckpt_dir)
            state = trainer.restore_state(payload)
            del payload
            if primary:
                print(f"resumed from iteration {start_step}", flush=True)
    if state is None:
        state = trainer.init_state(seed)
    # the step's route; a resumed run restores before this, so the graphs
    # are captured on the restored state's tensors
    graphs = cuda_graphs.capturable(dev)
    step_fn = trainer.compile_step(state) if graphs else trainer.train_step
    if primary:
        print(f"train step: {'captured CUDA graphs' if graphs else 'eager'}"
              f" ({type(trainer).__name__} on {dev})", flush=True)

    bs = multihost.local_batch_size(cfg.batch_size, trainer.data_size)
    train_a, train_b, test_a, test_b = get_all_data_loaders(
        cfg, synthetic=synthetic, batch_size=bs,
        shard_index=trainer.data_index, shard_count=trainer.data_size,
        start_batch=start_step)
    # fixed display rows: epoch 0's, whatever the resume point; rank 0's
    # everywhere, since sampling is a collective over the same pixels
    disp_n = min(cfg.display_size, bs)
    disp_a = multihost.broadcast_host(test_a.head_rows(disp_n))
    disp_train_a = multihost.broadcast_host(train_a.head_rows(disp_n))
    crop_h, crop_w = cfg.data.crop_image_height, cfg.data.crop_image_width
    h, w = cfg.data.new_size, cfg.data.new_size
    # in-training FID against the test split; its inputs are head_rows, so
    # it neither consumes nor races the loaders' streams
    eval_hook = (TrainEvalHook(cfg, trainer, test_a, test_b)
                 if cfg.eval_iter else None)
    logger = MetricLogger(run_dir) if primary else None

    limit = min(cfg.max_iter, max_steps + start_step if max_steps
                else cfg.max_iter)
    step = start_step
    it_a, it_b = iter(train_a), iter(train_b)
    pin = dev.type == "cuda"

    def stage(s: int):
        """Host work for step s: the loaders' next batches and their crops,
        pinned for a non-blocking copy. Keyed by s alone, so staging ahead
        changes nothing."""
        a_u8, b_u8 = next(it_a), next(it_b)
        # the crops and flips of these rows' global indices
        rows = range(trainer.data_index * bs, (trainer.data_index + 1) * bs)
        out = (torch.from_numpy(a_u8), torch.from_numpy(b_u8),
               draw_crops(seed, s, _STREAM_A, rows, h, w, crop_h, crop_w),
               draw_crops(seed, s, _STREAM_B, rows, h, w, crop_h, crop_w))
        return tuple(t.pin_memory() for t in out) if pin else out

    def upload(staged):
        a, b, ca, cb = (t.to(dev, non_blocking=True) for t in staged)
        return (augment_batch(a, crop_h, crop_w, crops=ca),
                augment_batch(b, crop_h, crop_w, crops=cb))

    # one-step-deep host pipeline: one worker, so the loaders are consumed
    # strictly in step order; it pins, so it holds the card as current
    pool = pending = None
    if cfg.host_prefetch:
        init = None
        if pin:
            index = (torch.cuda.current_device() if dev.index is None
                     else dev.index)
            init = lambda: torch.cuda.set_device(index)  # noqa: E731
        pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="councilx_torch-stage",
            initializer=init)
        pending = pool.submit(stage, step)

    t_window = time.perf_counter()
    window_steps = 0
    images_per_sec = 0.0
    interrupted = False
    prof = None
    held = {"stage_wait": 0.0, "write_wait": 0.0}
    copy_s = []
    last_snapshot = None
    try:
        while step < limit:
            if stop_event is not None and n_proc == 1 \
                    and stop_event.is_set():
                interrupted = True
                break
            if pending is not None:
                t0 = time.perf_counter()
                staged = pending.result()
                held["stage_wait"] += time.perf_counter() - t0
                pending = (pool.submit(stage, step + 1)
                           if step + 1 < limit else None)
            else:
                staged = stage(step)
            x_a, x_b = upload(staged)

            if primary and profile_steps and step == profile_steps.start:
                prof = _start_profile(dev)
            state, metrics = step_fn(state, x_a, x_b)
            step += 1
            window_steps += 1
            if prof is not None and step >= profile_steps.stop:
                _stop_profile(prof, dev, run_dir)
                prof = None

            if step % cfg.log_iter == 0:
                host = mask_skipped_metrics(_host_metrics(metrics))
                now = time.perf_counter()
                images_per_sec = (window_steps * cfg.batch_size
                                  / max(now - t_window, 1e-9))
                t_window, window_steps = now, 0
                if primary:
                    host["images_per_sec"] = images_per_sec
                    logger.write(step, host)

            # the translate is a collective under member parallelism; the
            # features and the FID are rank 0's
            if eval_hook is not None and step % cfg.eval_iter == 0:
                fids = eval_hook(trainer, state, primary=primary)
                if primary:
                    logger.write(step, fids)

            if cfg.image_save_iter and step % cfg.image_save_iter == 0:
                _write_samples(trainer, state, disp_a, disp_train_a,
                               image_dir, step, crop_h, crop_w, seed,
                               write=primary)
                if primary:
                    write_html(os.path.join(run_dir, "index.html"),
                               image_dir, step, cfg.image_save_iter)

            # a rolling "current" sheet (overwritten, not archived)
            if cfg.image_display_iter and step % cfg.image_display_iter == 0:
                _write_sheet(trainer, state, disp_a, image_dir, "current",
                             trainer.directions[0], step, crop_h, crop_w,
                             seed, write=primary)

            if cfg.snapshot_save_iter and step % cfg.snapshot_save_iter == 0:
                t0 = time.perf_counter()
                wait_for_checkpoints()
                t1 = time.perf_counter()
                last_snapshot = save_checkpoint(ckpt_dir, state, step,
                                                async_save=True,
                                                trainer=trainer)
                held["write_wait"] += t1 - t0
                copy_s.append(time.perf_counter() - t1)
    finally:
        # a compiled step's graphs hold the NCCL communicators their
        # collectives use, and destroying a process group waits for every
        # such graph to be freed: drop the step here, on an error too
        capture_seconds = (list(step_fn.capture_seconds.values())
                           if graphs else [])
        step_fn = None
        if prof is not None:
            _stop_profile(prof, dev, run_dir)
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        it_a.close()
        it_b.close()
        if logger is not None:
            logger.close()
    t0 = time.perf_counter()
    wait_for_checkpoints()
    held["write_wait"] += time.perf_counter() - t0
    final_s = 0.0
    if last_snapshot != os.path.abspath(os.path.join(
            ckpt_dir, f"step_{step:08d}")):
        t0 = time.perf_counter()
        last_snapshot = save_checkpoint(ckpt_dir, state, step,
                                        trainer=trainer)
        final_s = time.perf_counter() - t0
    return {"step": step, "start_step": start_step,
            "images_per_sec": images_per_sec, "interrupted": interrupted,
            "graphs": graphs,
            "capture_seconds": capture_seconds,
            "native": train_a.native and train_b.native,
            "stage_wait_seconds": held["stage_wait"],
            "snapshot_copy_seconds": copy_s,
            "snapshot_write_wait_seconds": held["write_wait"],
            "final_save_seconds": final_s,
            "snapshot_bytes": os.path.getsize(os.path.join(
                last_snapshot, SNAPSHOT_FILE)) if primary else None}


def _start_profile(dev: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profile(prof, dev: torch.device, run_dir: str) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.__exit__(None, None, None)
    out = os.path.join(run_dir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


def _write_sheet(trainer: CouncilTrainer, state, batch_u8, image_dir: str,
                 name: str, direction: str, step: int, crop_h: int,
                 crop_w: int, seed: int, write: bool = True) -> None:
    """One sample sheet: every member's translation of the center-cropped
    batch, with z keyed by the step (the training z stream is not
    touched). ``write=False`` samples (a collective under member
    parallelism) and writes no file."""
    x = augment_batch(torch.from_numpy(batch_u8).to(trainer.device), crop_h,
                      crop_w, train=False)
    g = torch.Generator().manual_seed(row_seed(seed, step, _STREAM_SAMPLE,
                                               0))
    z = torch.randn((trainer.n, x.shape[0], trainer.cfg.gen.style_dim),
                    generator=g)
    x_t, mask = trainer.sample(state, x, direction=direction, z=z)
    if not write:
        return
    write_sample_sheet(image_dir, name, x.cpu().numpy(),
                       x_t.float().cpu().numpy(),
                       mask.float().cpu().numpy() if mask is not None
                       else None)


def _write_samples(trainer: CouncilTrainer, state, test_u8, train_u8,
                   image_dir: str, step: int, crop_h: int, crop_w: int,
                   seed: int, write: bool = True) -> None:
    """Per-member sample sheets of the test and train display batches
    (reference Council_Trainer.sample + utils.write_2images), one per
    direction under the same name, as the JAX package writes them."""
    for tag, batch in (("test", test_u8), ("train", train_u8)):
        for d in trainer.directions:
            _write_sheet(trainer, state, batch, image_dir,
                         f"{tag}_{step:08d}", d, step, crop_h, crop_w, seed,
                         write)
