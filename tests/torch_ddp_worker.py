"""One process of `tests/test_torch_ddp.py`: the port's SSOD trainer on a
small seeded config (YOLOv5 at width 0.125, nc 2, 64 px, float32 on the
CPU, LabelMatch on), 1 burn-in epoch of one step, then 2 SSOD epochs of
one step each, on a global batch of 8 labelled + 8 unlabelled images.

    python tests/torch_ddp_worker.py <out_dir> <project_dir>

With torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
the process joins a gloo group and takes its contiguous share of every
global batch; without it, it takes the whole batch. It writes
`<out_dir>/rank<r>.pt`: every step's loss parts summed over the ranks,
the student's and the teachers' weights and BatchNorm statistics, the
LabelMatch thresholds after each refresh, and the files the process
created or wrote under `project_dir` (an audit hook records them).
"""

import os
import sys
import types
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from efficientteacher_torch.configs import get_cfg  # noqa: E402
from efficientteacher_torch.parallel.distributed import (  # noqa: E402
    global_sum, maybe_initialize, shutdown, world_size)
from efficientteacher_torch.train.ssod_trainer import SSODTrainer  # noqa

B, IMG, NC = 8, 64, 2
CFG = ["Model.Backbone.name", "YoloV5", "Model.Neck.name", "YoloV5",
       "Model.Head.name", "YoloV5", "Model.Backbone.activation", "SiLU",
       "Model.Neck.activation", "SiLU",
       "Model.Neck.in_channels", [256, 512, 1024],
       "Model.Neck.out_channels", [256, 512, 1024],
       "Model.width_multiple", 0.125, "Model.depth_multiple", 0.34,
       "Loss.type", "ComputeLoss", "Dataset.nc", NC,
       "Dataset.names", ["a", "b"], "Dataset.img_size", IMG,
       "Dataset.max_targets", 16, "Dataset.batch_size", B, "epochs", 3,
       "SSOD.train_domain", True, "SSOD.nms_conf_thres", 0.1,
       "SSOD.max_pseudo_labels", 16, "SSOD.fixed_accumulate", True,
       "SSOD.pseudo_label_type", "LabelMatch",
       "SSOD.dynamic_thres_epoch", 0, "hyp.burn_epochs", 1,
       "hyp.warmup_epochs", 0, "name", "ddp"]


def _share(x):
    """This process's contiguous share of a global batch array."""
    rank, world = (torch.distributed.get_rank(), world_size()) \
        if world_size() > 1 else (0, 1)
    n = len(x) // world
    return x[rank * n:(rank + 1) * n]


def _sup_batch(rng, share=True):
    labels = np.zeros((B, 4, 5), np.float32)
    mask = np.zeros((B, 4), bool)
    for i in range(B):
        k = int(rng.integers(1, 4))
        labels[i, :k, 0] = rng.integers(0, NC, k)
        labels[i, :k, 1:3] = rng.uniform(0.3, 0.7, (k, 2))
        labels[i, :k, 3:5] = rng.uniform(0.15, 0.4, (k, 2))
        mask[i, :k] = True
    images = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    batch = {"images": images, "labels": labels, "mask": mask}
    if share:
        batch = {k: _share(v) for k, v in batch.items()}
    return {**batch, "shapes": [None] * len(batch["images"])}


def _target_batch(rng):
    m_s = np.zeros((B, 13), np.float32)
    m_s[:, 0] = np.arange(B)
    m_s[:, 1:10] = np.eye(3).ravel()
    m_s[:, 10] = 1.0
    im = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    m_s = _share(m_s).copy()
    m_s[:, 0] = np.arange(len(m_s))
    return {"images": _share(im), "images_ori": _share(im).copy(),
            "M_s": m_s}


class Replay(list):
    def __init__(self, batches, ds=None):
        super().__init__(batches)
        self.ds = ds


class DDPTrainer(SSODTrainer):
    def build_dataloader(self, cfg):
        rng = np.random.default_rng(0)
        self.dataset = types.SimpleNamespace(
            mosaic=True, label_num_per_image=1.5,
            cls_ratio_gt=np.full(NC, 0.5))
        self.train_loader = Replay([_sup_batch(rng)], self.dataset)
        self.target_loader = Replay([_target_batch(rng)], range(16))
        # the whole val set: rank 0 alone validates it
        self.val_loader = Replay([_sup_batch(np.random.default_rng(9),
                                             share=False)])
        self.nb = 1

    def build_model(self, cfg):
        super().build_model(cfg)
        # an EMA that gives pseudo labels from the first SSOD step
        no = 5 + NC
        with torch.no_grad():
            for k, v in self.model.state_dict().items():
                if k.endswith("conv.weight"):
                    v.mul_(1.6)
                if k.startswith("head.m.") and k.endswith("bias"):
                    v.view(-1, no)[:, 4] += 4.0
                    v.view(-1, no)[:, 5:] += 2.5

    def build_step(self):
        super().build_step()
        self.losses, self.thr = [], []
        burn, ssod = self.burn_step, self.ssod_step

        def log(parts):
            keys = sorted(k for k in parts if k != "total")
            vals = torch.stack([parts[k].detach().double().reshape(())
                                for k in keys])
            self.losses.append(dict(zip(keys, global_sum(vals).tolist())))

        def run_burn(state, *args):
            state, parts = burn(state, *args)
            log(parts)
            return state, parts

        def run_ssod(state, *args):
            state, out = ssod(state, *args)
            log(out.metrics)
            return state, out

        self.burn_step, self.ssod_step = run_burn, run_ssod

    def after_epoch(self):
        super().after_epoch()
        lm = self.label_match
        self.thr.append((lm.cls_thr_high.copy(), lm.cls_thr_low.copy()))


def main(out_dir, project):
    torch.set_num_threads(1)
    torch.manual_seed(0)
    written = []

    def audit(event, args):
        if event == "open" and isinstance(args[0], (str, os.PathLike)):
            mode = args[1] if isinstance(args[1], str) else ""
            if any(c in mode for c in "wax+"):
                written.append(str(args[0]))
        elif event in ("os.mkdir", "os.rename", "os.remove"):
            written.append(str(args[0]))

    device = maybe_initialize(torch.device("cpu"))
    sys.addaudithook(audit)
    cfg = get_cfg()
    cfg.merge_from_list(CFG + ["project", project])
    cfg.freeze()
    t = DDPTrainer(cfg, compute_dtype=torch.float32, device=device)
    t.train()
    st = t.state
    rank = 0 if world_size() == 1 else torch.distributed.get_rank()
    out = {
        "world": world_size(), "losses": t.losses, "thr": t.thr,
        "written": sorted({w for w in written if w.startswith(project)}),
        "model": {k: v.detach().clone() for k, v in
                  st.model.state_dict().items()},
        "ema": {k: v.clone() for k, v in st.ema.module.state_dict().items()},
        "teacher": {k: v.clone() for k, v in
                    st.semi_ema.module.state_dict().items()},
        "updates": (st.ema.updates, st.semi_ema.updates, st.opt_step),
    }
    shutdown()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
