"""Train and predict entry points behind ``python -m fast_eng_super_resolution_tpu_torch``.

Mirrors the entry scripts' flow (reference run_ALDS_3D.py:10-41): build the
scheduler, then train, or predict per sample index, reconstruct with overlap
averaging, write ``logs/vtk/{exp}/pred_{idx}.vtu`` and print the two timing
spans the reference prints (:19-29).  Under ``torchrun`` with
``FESR_MULTIHOST=1`` every rank trains and serves its share on its own card
(``utils.env.maybe_init_distributed``) and rank 0 alone writes.
"""

from __future__ import annotations

import os

import numpy as np

from .data.reconstruct import overlap_average
from .data.tensorize import infer_cell_types
from .data.vtu import write_vtu
from .sched.scheduler import PartitionScheduler
from .utils.env import finalize_distributed, is_primary, maybe_init_distributed
from .utils.logging import span


def train_graph_ALDD(exp_name: str, model, dataset, num_partitions: int,
                     train_config: dict, start_from_pretrained: bool = False,
                     log_dir: str = "logs", device=None, **kwargs):
    """Trains the partition experts on ``dataset`` and writes their
    checkpoints under ``log_dir``; returns the scheduler.  Runs on ``cuda``
    unless ``device="cpu"``, in the device's default training layout;
    ``FESR_FUSED_TRAIN=0`` selects the plain 'merged' layout.  With
    ``num_partitions`` > 1, ``kwargs`` carry the ``encoder`` and
    ``classifier`` that route the subdomains (fitted and saved here)."""
    scheduler = PartitionScheduler(exp_name, num_partitions, dataset, model,
                                   train=True, log_dir=log_dir,
                                   device=device, **kwargs)
    layout = "merged" if os.environ.get("FESR_FUSED_TRAIN", "1") == "0" else None
    scheduler.train(train_config, start_from_pretrained=start_from_pretrained,
                    layout=layout)
    return scheduler


def pred_graph_ALDD(idxs, exp_name: str, model, dataset, num_partitions: int,
                    save_mode: str = "save_png", log_dir: str = "logs",
                    smooth: bool = False, device=None,
                    lanes: list | None = None, **kwargs):
    """Serves mesh ``idx`` of ``dataset`` for each idx in ``idxs`` and writes
    one ``.vtu`` each; returns their paths.  Runs on ``cuda`` unless
    ``device="cpu"``.  ``lanes``, when given, receives (idx, lane, reason)
    per mesh: the serving lane the scheduler took.  With ``num_partitions``
    > 1, ``kwargs`` carry the ``encoder`` and ``classifier`` (their saved
    state is loaded).  ``smooth=True`` projects each stitched prediction
    to a divergence-free field (``physics.smooth_with_continuity``, on the
    same device) before the ``.vtu`` is written; its pressure is then the
    solve's correction field, as in the JAX package."""
    scheduler = PartitionScheduler(exp_name, num_partitions, dataset, model,
                                   train=False, log_dir=log_dir,
                                   device=device, **kwargs)
    outputs = []
    for idx in idxs:
        x = dataset.get_one_full_sample(idx)
        full = dataset.full_mesh(idx)
        num_nodes = len(full["points"])

        # serving fast path: fused predict + device-side segment-mean
        # reconstruction (scheduler.predict_full) — falls back to the general
        # predict + host overlap_average when its preconditions don't hold
        # (missing global ids, per-subdomain field norm, over edge budget);
        # routed experts take the routed lane
        with span("Prediction"):
            fast = scheduler.predict_full(x, num_nodes)
            if fast is None:
                pred_y_list, ref_y_list, model_idx, weights_list = \
                    scheduler.predict(x)
        if lanes is not None:
            lanes.append((idx, *scheduler.last_lane))

        if fast is not None:
            with span("Reconstruction"):  # already stitched on device
                pred, ref = fast
        else:
            if x and x[0].get("field_scale") is not None:
                # per_subdomain_field_norm: model I/O is amplitude-normalized
                # per subdomain; re-scale to physical units before stitching
                pred_y_list = [np.asarray(p) * d["field_scale"]
                               for p, d in zip(pred_y_list, x)]
                ref_y_list = [np.asarray(r) * d["field_scale"]
                              for r, d in zip(ref_y_list, x)]

            with span("Reconstruction"):
                gids = [d.get("global_node_ids") for d in x]
                if any(g is None for g in gids):
                    # reference-produced duct partition caches carry no global
                    # ids (GraphDataset.py:615-620); recover them by coordinate
                    # match (:1371-1400)
                    from scipy.spatial import cKDTree

                    tree = cKDTree(full["points"])
                    gids = [g if g is not None else
                            tree.query(d["pos"], workers=-1)[1].astype(np.int64)
                            for g, d in zip(gids, x)]
                pred = overlap_average(pred_y_list, gids, num_nodes)
                ref = overlap_average([np.asarray(r) for r in ref_y_list],
                                      gids, num_nodes)

        out_path = os.path.join(log_dir, "vtk", exp_name, f"pred_{idx}.vtu")
        outputs.append(out_path)
        if not is_primary():  # every rank holds the result; rank 0 writes
            continue
        if smooth:
            from .data.tensorize import cells_to_edges
            from .physics.projection import smooth_with_continuity

            edges = cells_to_edges(full["cells"])
            with span("Smoothing"):
                v, p = smooth_with_continuity(full["points"], edges,
                                              pred[:, :3], pred[:, 3],
                                              device=device)
            pred = np.concatenate([np.asarray(v),
                                   np.asarray(p).reshape(-1, 1)], 1)

        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        cells = full["cells"]
        write_vtu(out_path, full["points"], cells,
                  infer_cell_types(cells),
                  point_data={
                      "velocity": pred[:, :3], "pressure": pred[:, 3],
                      "ref_velocity": ref[:, :3], "ref_pressure": ref[:, 3],
                      "interpolated_velocity": full["x"][:, :3],
                      "interpolated_pressure": full["x"][:, 3],
                  })
        print("Prediction done!")
    return outputs


def main(args):
    """``__main__`` body (reference run_ALDS_3D.py:44-73).

    Trains or serves on the exp config's ``device`` key (``cpu``), else on
    ``cuda``.  With ``FESR_MULTIHOST=1`` (under ``torchrun``, or with the
    ``FESR_*`` rendezvous variables) the process first joins its group:
    NCCL on its card, gloo with ``device: cpu``.  With ``n_clusters`` != 1
    the ``--encoder`` and ``--classifier`` route the subdomains to that many
    experts.  The grid models (``GRID_MODELS``) train and predict through
    ``grid_runner``."""
    from .utils.config import load_yaml

    exp_config = load_yaml(args.exp_config)
    joined = maybe_init_distributed(device=exp_config.get("device"))
    try:
        return _main(args, exp_config)
    finally:
        if joined:
            finalize_distributed()


def _main(args, exp_config: dict):
    from .data.dataset import init_dataset
    from .models.registry import GRID_MODELS, init_model
    from .sched.classifiers import init_classifier
    from .sched.encoders import init_encoder
    from .utils.config import load_yaml

    n_clusters = exp_config["n_clusters"]
    if args.mode not in ("train", "pred", "predict"):  # README: 'predict'
        raise ValueError(f"Unknown mode: {args.mode}")
    model = init_model(args.model, **exp_config)
    dataset = init_dataset(args.dataset, **exp_config)
    kwargs = dict(device=exp_config.get("device"))
    if args.model in GRID_MODELS:
        # the dense-tensor family trains on [B, *S, C] samples, not on the
        # graph scheduler (grid_runner.py)
        from .grid_runner import pred_grid, pred_rollout, train_grid

        print("Dataset loaded!")
        if args.mode == "train":
            return train_grid(args.exp_name, model, dataset,
                              load_yaml(args.train_config), exp_config,
                              **kwargs)
        if getattr(dataset, "rollout_eval", False):
            return pred_rollout(exp_config["idxs"], args.exp_name, model,
                                dataset, exp_config, **kwargs)
        return pred_grid(exp_config["idxs"], args.exp_name, model, dataset,
                         exp_config, **kwargs)
    if n_clusters != 1:
        kwargs["encoder"] = init_encoder(args.encoder, **exp_config)
        kwargs["classifier"] = init_classifier(args.classifier, **exp_config)
    print("Dataset loaded!")
    if args.mode == "train":
        train_config = load_yaml(args.train_config)
        train_dataset = dataset
        train_meshes = exp_config.get("train_meshes")
        if train_meshes is not None:
            # mesh-level held-out split: training sees only these meshes;
            # pred mode still reaches all meshes via ``idxs``
            from .data.subsets import SubGraphDataset

            flat = np.concatenate([dataset.mesh_subdomain_indices(m)
                                   for m in train_meshes])
            train_dataset = SubGraphDataset(dataset, flat)
            print(f"Training restricted to meshes {list(train_meshes)} "
                  f"({len(flat)} subdomains)")
        return train_graph_ALDD(args.exp_name, model, train_dataset,
                                n_clusters, train_config, **kwargs)
    return pred_graph_ALDD(exp_config["idxs"], args.exp_name, model, dataset,
                           n_clusters, exp_config.get("save_mode", "save_png"),
                           smooth=exp_config.get("smooth", False), **kwargs)
