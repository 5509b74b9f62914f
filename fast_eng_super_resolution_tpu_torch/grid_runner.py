"""Train and predict entry points of the grid model family (FNO1d/2d/3d,
DeepONet) behind ``python -m fast_eng_super_resolution_tpu_torch
--model=fno --dataset=advected_grid --mode={train,pred}``.

Parity target: the JAX package's ``grid_runner.py``.  Training goes through
``parallel.grid_train.GridTrainer`` with the train-config schema of the
graph path (epochs, batch_size, lr, StepLR's step_size and gamma,
val_interval) and the same order of samples (``np.random.default_rng(0)``,
each epoch's permutation cut to full batches); the best-validation
parameters go to ``logs/models/collection_{exp}/partition_0.npz`` in the
JAX package's flat-key layout with the task-spec stamp, so either package
serves the other's checkpoint.  Prediction writes
``logs/vtk/{exp}/pred_{idx}.npz`` (pred, ref, input) and prints the
held-out MSE improvement over the upsampled-coarse baseline.  The rollout
lane (``pred_rollout``) composes a trained one-step model over a
trajectory dataset's horizon from each held-out trajectory's first frame.
All run on ``cuda`` unless the caller (or the exp config's ``device``) says
``cpu``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .parallel.grid_train import shard_grid_epoch
from .parallel.mesh import make_mesh, replicate
from .utils.device import resolve_device
from .utils.env import is_primary
from .utils.logging import MetricLogger, span

def _collection_path(log_dir: str, exp_name: str) -> str:
    d = os.path.join(log_dir, "models", f"collection_{exp_name}")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "partition_0.npz")


def _task_spec(model, dataset, exp_config: dict) -> dict:
    """The serve-relevant identity of the training task stamped into the
    checkpoint: dataset class, grid resolution, coarse-input downsample
    factor, horizon and guidance flags, model class.  A checkpoint served
    on a mismatched coarse grid does worse than the baseline."""
    spec = {"task": type(dataset).__name__, "model": type(model).__name__}
    for k in ("resolution", "downsample", "t_frames", "t_end", "guided"):
        v = exp_config.get(k, getattr(dataset, k, None))
        if v is None:
            continue
        if isinstance(v, bool):
            sv = str(v)
        elif isinstance(v, (int, float, np.integer, np.floating)):
            sv = format(float(v), "g")   # '2' == '2.0' across yaml styles
        else:
            sv = str(v)
        spec[f"task_{k}"] = sv
    return spec


def _check_task_spec(path: str, model, dataset, exp_config: dict) -> None:
    """Refuses (or warns about) a checkpoint whose task spec differs from the
    request's.  Mode: exp key ``task_spec_guard``, else the environment's
    ``FESR_TASKSPEC_GUARD``, else 'error' (refuse); 'warn' prints and
    serves (deliberate transfer experiments), 'off' skips.  A checkpoint
    without a stamp always passes."""
    from .core import checkpoint as ckpt

    mode = str(exp_config.get("task_spec_guard")
               or os.environ.get("FESR_TASKSPEC_GUARD", "error")).lower()
    if mode == "off":
        return
    meta = ckpt.load_meta(path)
    if not meta:
        return
    spec = _task_spec(model, dataset, exp_config)
    mism = {k: (meta[k], str(v)) for k, v in spec.items()
            if k in meta and meta[k] != str(v)}
    if not mism:
        return
    detail = ", ".join(f"{k}: trained={a!r} vs request={b!r}"
                       for k, (a, b) in sorted(mism.items()))
    msg = (f"checkpoint task-spec mismatch ({detail}). Serving a model "
           "against a different task/resolution than it was trained on is "
           "usually worse than the baseline (measured 0.25x on a "
           "mismatched coarse grid); set task_spec_guard: warn (or "
           "FESR_TASKSPEC_GUARD=warn) for deliberate transfer experiments.")
    if mode == "error":
        raise ValueError(msg)
    print(f"WARNING: {msg}")


def _stack(dataset, idxs) -> tuple[np.ndarray, np.ndarray]:
    x = np.stack([dataset[i]["x"] for i in idxs])
    y = np.stack([dataset[i]["y"] for i in idxs])
    return x, y


def _split(dataset, exp_config: dict) -> tuple[list[int], list[int]]:
    """Train/val split: ``train_samples: K`` takes the first K samples for
    training and holds out the rest; without it, the reference's 80/20
    random split (scheduler_gnn.py:100-103)."""
    n = len(dataset)
    k = exp_config.get("train_samples")
    if k is not None:
        k = int(k)
        if not 0 < k < n:
            raise ValueError(f"train_samples={k} must be in (0, {n})")
        return list(range(k)), list(range(k, n))
    from .parallel.train import train_val_split

    tr, va = train_val_split(n)
    return list(tr), list(va)


def train_grid(exp_name: str, model, dataset, train_config: dict,
               exp_config: dict, log_dir: str = "logs", device=None) -> dict:
    """Trains a grid model; the best-validation parameters are the
    checkpoint.  Returns {'best_val', 'ckpt'}."""
    from .core import checkpoint as ckpt
    from .parallel.grid_train import GridTrainer
    from .parallel.train import StepLR

    dev = resolve_device(device)
    train_idx, val_idx = _split(dataset, exp_config)
    x_tr, y_tr = _stack(dataset, train_idx)
    x_va, y_va = _stack(dataset, val_idx)
    target_c = int(y_tr.shape[-1])

    lr = float(train_config["lr"])
    epochs = int(train_config["epochs"])
    batch_size = min(int(train_config.get("batch_size", len(train_idx))),
                     len(train_idx))
    sched = StepLR(lr, int(train_config.get("step_size", 30)),
                   float(train_config.get("gamma", 0.1)))
    val_interval = int(train_config.get("val_interval", 10))

    trainer = GridTrainer(model.to(dev), lr=lr, out_channels=target_c)
    opt = trainer.init(int(exp_config.get("seed", 0)), x_tr)
    # upload once; each batch is an index gather on the device
    x_tr, y_tr, x_va, y_va = (torch.as_tensor(a, device=dev)
                              for a in (x_tr, y_tr, x_va, y_va))
    # data parallelism over a process group of several ranks when the
    # batch divides over them (FESR_GRID_DP=0 keeps one device's loop on
    # each rank): every rank steps on its block of each batch, gradients
    # averaged, parameters broadcast from rank 0 first
    mesh = make_mesh(dev)
    use_dp = (mesh.size > 1 and batch_size % mesh.size == 0
              and os.environ.get("FESR_GRID_DP", "1") != "0")
    if use_dp:
        replicate(trainer.net, mesh)

    logger = MetricLogger(exp_name, log_dir, config=dict(train_config))
    rng = np.random.default_rng(0)
    best_val = float("inf")
    primary = is_primary()
    path = _collection_path(log_dir, exp_name)
    spec = _task_spec(model, dataset, exp_config)
    n_tr = len(train_idx)
    n_batches = max(1, n_tr // batch_size)
    for epoch in range(epochs):
        # the permutation is cut to full batches: with shuffling every
        # sample is still seen with equal probability across epochs
        order = rng.permutation(n_tr)[: n_batches * batch_size]
        order = order.reshape(n_batches, batch_size)
        if use_dp:
            xs, ys = shard_grid_epoch(x_tr[order], y_tr[order], mesh)
            losses = trainer.epoch_stacked(opt, xs, ys, mesh)
        else:
            losses = trainer.epoch(opt, x_tr, y_tr, order)
        trainer.set_lr(opt, sched(epoch + 1))
        if epoch % val_interval == 0 or epoch == epochs - 1:
            # the losses' host read stays in the val branch: one sync per
            # validation, not per epoch
            train_loss = float(np.mean(losses.cpu().numpy()))
            val_loss = trainer.evaluate(x_va, y_va)
            # the LR this epoch trained under, not the next one's
            logger.log({"train_loss": train_loss, "val_loss": val_loss,
                        "lr": sched(epoch)}, step=epoch)
            if val_loss < best_val:
                best_val = val_loss
                if primary:
                    ckpt.save_params(path, trainer.net.to_jax_params(),
                                     meta=spec)
            print(f"Epoch {epoch}: train {train_loss:.6f} val {val_loss:.6f}")
    if not np.isfinite(best_val) and primary:
        # diverged run (every val loss NaN/inf): the last parameters, so
        # pred_grid finds a checkpoint
        ckpt.save_params(path, trainer.net.to_jax_params(), meta=spec)
    logger.finish()
    mesh.barrier()  # rank 0's checkpoint is written
    print(f"Best val loss {best_val:.6f} -> {path}")
    return {"best_val": best_val, "ckpt": path}


def pred_grid(idxs, exp_name: str, model, dataset, exp_config: dict,
              log_dir: str = "logs", device=None) -> list[str]:
    """Predicts samples ``idxs`` from the checkpoint; writes
    ``pred_{idx}.npz`` each and prints the improvement line."""
    from .core import checkpoint as ckpt
    from .parallel.grid_train import GridTrainer

    dev = resolve_device(device)
    path = _collection_path(log_dir, exp_name)
    _check_task_spec(path, model, dataset, exp_config)
    trainer = GridTrainer(model.to(dev), lr=0.0)
    trainer.net.from_jax_params(ckpt.load_params(path))
    out_dir = os.path.join(log_dir, "vtk", exp_name)
    os.makedirs(out_dir, exist_ok=True)
    outputs = []
    for idx in idxs:
        s = dataset[idx]
        x, y = s["x"][None], s["y"][None]
        with span("Prediction"):
            pred = trainer.predict(torch.as_tensor(x, device=dev)).cpu().numpy()
        # inputs may carry auxiliary channels after the field channels (the
        # Darcy coefficient, the NS initial condition): the baseline is the
        # interpolated field alone
        mse_base = float(((x[..., : y.shape[-1]] - y) ** 2).mean())
        mse_pred = float(((pred - y) ** 2).mean())
        factor = mse_base / max(mse_pred, 1e-30)
        out_path = os.path.join(out_dir, f"pred_{idx}.npz")
        if is_primary():
            np.savez(out_path, pred=pred[0], ref=y[0], input=x[0])
        print(f"pred_{idx}: baseline MSE {mse_base:.6e}, model MSE "
              f"{mse_pred:.6e}, improvement {factor:.2f}x")
        print("Prediction done!")
        outputs.append(out_path)
    return outputs


# rollout_impl 'auto': the form measured faster on the card (PERF.md)
AUTO_ROLLOUT_IMPL = "scan"


@torch.no_grad()
def rollout(net, frame0: torch.Tensor, coarse_tmaj: np.ndarray,
            static: torch.Tensor | None, guided: bool,
            impl: str = "scan") -> torch.Tensor:
    """T one-step forwards of ``net`` from ``frame0`` [B, *sp] (on the
    device), each step's input ``[frame, (coarse_t if guided), *static]``
    (the datasets' one-step channel order); returns the frames [T, B, *sp]
    on the device.  ``coarse_tmaj`` [T, B, *sp] is the host guidance
    sequence: 'scan' uploads it once before the loop, 'stepwise' uploads
    each step's frame as the step needs it.  The two give the same bits."""
    if impl not in ("scan", "stepwise"):
        raise ValueError(f"rollout_impl={impl!r} (expected scan | stepwise "
                         "| auto)")
    dev = frame0.device
    coarse = None
    if guided and impl == "scan":
        coarse = torch.as_tensor(np.ascontiguousarray(coarse_tmaj),
                                 device=dev)
    f, outs = frame0, []
    for t in range(coarse_tmaj.shape[0]):
        chans = [f[..., None]]
        if guided:
            chans.append((coarse[t] if coarse is not None else
                          torch.as_tensor(coarse_tmaj[t], device=dev))[..., None])
        if static is not None:
            chans.append(static)
        f = net(chans[0] if len(chans) == 1 else torch.cat(chans, -1))[..., 0]
        outs.append(f)
    return torch.stack(outs)


def pred_rollout(idxs, exp_name: str, model, dataset, exp_config: dict,
                 log_dir: str = "logs", device=None) -> list[str]:
    """Autoregressive rollout evaluation over the held-out trajectories.

    Rolls the trained one-step model from each trajectory's first frame for
    T frames, all held-out trajectories in one batch (``rollout``), then
    scores the final frame against the fine solve, with the upsampled coarse
    solve's final frame as the improvement baseline (the one-shot 'ns_grid'
    lane's baseline, so the numbers compare directly).  With
    ``train_samples`` in the exp config the held-out trajectories are those
    after the first ``train_samples / t_frames`` (it must be a multiple of
    ``t_frames``), else ``idxs``.  Writes ``pred_{idx}.npz`` (pred, ref,
    input, rollout, and coarse when guided) per held-out ``idx`` and prints
    the pred_grid lines plus the all-held-out mean.  ``rollout_impl`` in
    the exp config: 'scan', 'stepwise' or 'auto' (``AUTO_ROLLOUT_IMPL``)."""
    from .core import checkpoint as ckpt
    from .parallel.grid_train import GridTrainer

    dev = resolve_device(device)
    T = dataset.t_frames
    k_pairs = exp_config.get("train_samples")
    n_traj = dataset.trajectories.shape[0]
    if k_pairs is not None:
        # trajectory-major one-step pairs: a train_samples that is not a
        # whole number of trajectories would put some of the boundary
        # trajectory's pairs in the training split while this evaluation
        # still counted it held-out
        if int(k_pairs) % T != 0:
            raise ValueError(
                f"train_samples={k_pairs} must be a multiple of "
                f"t_frames={T} for rollout evaluation (whole held-out "
                f"trajectories)")
        eval_idx = list(range(int(k_pairs) // T, n_traj))
    else:
        eval_idx = sorted(int(i) for i in idxs)
    path = _collection_path(log_dir, exp_name)
    _check_task_spec(path, model, dataset, exp_config)
    trainer = GridTrainer(model.to(dev), lr=0.0)
    trainer.net.from_jax_params(ckpt.load_params(path))

    traj = dataset.trajectories[eval_idx]      # [B, T+1, *sp]
    coarse = dataset.coarse_frames[eval_idx]   # [B, T, *sp]
    guided = dataset.guided
    # static per-trajectory input channels (the advected family's velocity
    # [B, *sp, K]); None for self-contained dynamics like NS
    static = getattr(dataset, "static_fields", None)
    static_d = (None if static is None
                else torch.as_tensor(np.asarray(static[eval_idx]), device=dev))

    impl = str(exp_config.get("rollout_impl", "auto"))
    if impl == "auto":
        impl = AUTO_ROLLOUT_IMPL
    print(f"rollout_impl: {impl}")
    with span("Prediction"):
        frames = rollout(trainer.net, torch.as_tensor(traj[:, 0], device=dev),
                         np.moveaxis(coarse, 1, 0), static_d, guided,
                         impl).cpu().numpy()
    frames = np.moveaxis(frames, 0, 1)         # [B, T, *sp]

    fine = traj[:, 1:]                          # [B, T, *sp]
    ax = tuple(range(1, fine.ndim - 1))         # spatial axes of one frame
    axf = tuple(range(2, fine.ndim))            # spatial axes under [B, T]
    mse_roll_final = ((frames[:, -1] - fine[:, -1]) ** 2).mean(ax)
    mse_base_final = ((coarse[:, -1] - fine[:, -1]) ** 2).mean(ax)
    mse_roll_all = ((frames - fine) ** 2).mean(axf)      # [B, T]
    mse_base_all = ((coarse - fine) ** 2).mean(axf)

    out_dir = os.path.join(log_dir, "vtk", exp_name)
    os.makedirs(out_dir, exist_ok=True)
    outputs = []
    pos = {s: j for j, s in enumerate(eval_idx)}
    for idx in idxs:
        j = pos.get(int(idx))
        if j is None:
            print(f"pred_{idx}: not in the held-out range, skipped")
            continue
        factor = float(mse_base_final[j] / max(mse_roll_final[j], 1e-30))
        out_path = os.path.join(out_dir, f"pred_{idx}.npz")
        # a guided artifact carries the guidance sequence it consumed
        extra = {"coarse": coarse[j]} if guided else {}
        if is_primary():
            np.savez(out_path, pred=frames[j, -1][..., None],
                     ref=fine[j, -1][..., None],
                     input=traj[j, 0][..., None], rollout=frames[j], **extra)
        print(f"pred_{idx}: baseline MSE {float(mse_base_final[j]):.6e}, "
              f"model MSE {float(mse_roll_final[j]):.6e}, "
              f"improvement {factor:.2f}x")
        print("Prediction done!")
        outputs.append(out_path)

    mean_final = float((mse_base_final / np.maximum(mse_roll_final,
                                                    1e-30)).mean())
    mean_frames = float((mse_base_all / np.maximum(mse_roll_all,
                                                   1e-30)).mean())
    mode = "guided" if guided else "pure"
    print(f"rollout[{mode}] all-held-out mean over {len(eval_idx)} "
          f"trajectories: final-frame {mean_final:.2f}x, "
          f"per-frame {mean_frames:.2f}x")
    return outputs
