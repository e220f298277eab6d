"""Weights & Biases artifact surface (gated; a copy of
`efficientteacher_tpu/utils/wandb_artifacts.py`).

Parity with reference utils/loggers/wandb/wandb_utils.py behind the same
optional-import gate:
  - checkpoint artifacts with latest / best / "epoch N" aliases
    (WandbLogger.log_model :302-325)
  - resume / eval straight from a `wandb-artifact://` path
    (check_wandb_resume :69-80, download_model_artifact :284-300)
  - dataset upload as a versioned artifact with a preview table
    (log_dataset_artifact :326-369, create_dataset_table :380-420)

The reference's DDP config rewriting (process_wandb_config_ddp_mode
:83-105) is not copied: the port's trainers log on rank 0 alone; per-image
val logging tables (:422-473) are covered by utils/plots.py mosaics.

Everything resolves the wandb module lazily, so tests can inject a stub
into sys.modules and CI needs no network (wandb offline semantics)."""

from __future__ import annotations

import logging
import time
from pathlib import Path

LOGGER = logging.getLogger(__name__)

WANDB_ARTIFACT_PREFIX = "wandb-artifact://"


def _wandb():
    try:
        import wandb

        return wandb
    except Exception:  # pragma: no cover
        return None


def is_artifact_path(path) -> bool:
    """True for `wandb-artifact://entity/project/name:alias` references
    (reference remove_prefix/check_wandb_resume, wandb_utils.py:33,69)."""
    return isinstance(path, str) and path.startswith(WANDB_ARTIFACT_PREFIX)


def remove_prefix(path: str) -> str:
    return path[len(WANDB_ARTIFACT_PREFIX):] if is_artifact_path(path) \
        else path


def check_wandb_resume(weights) -> bool:
    """Reference check_wandb_resume (:69-80): a resume/weights target that
    names a wandb artifact requires the artifact download path."""
    return is_artifact_path(weights)


class WandbArtifacts:
    """Artifact uploads/downloads bound to a live wandb run."""

    def __init__(self, run):
        self.run = run

    # -- checkpoints --------------------------------------------------------
    def log_model(self, path, epoch: int, fitness: float,
                  best: bool = False, wait_s: float = 2.0) -> bool:
        """Upload a checkpoint as a `run_<id>_model` artifact (reference
        log_model :302-325; aliases latest + 'epoch N' + best). Checkpoint
        writes are async here, so waits briefly for the file; callers
        retry on the next save / at train end."""
        wandb = _wandb()
        if wandb is None:
            return False
        path = Path(path)
        deadline = time.time() + wait_s
        while not path.exists() and time.time() < deadline:
            time.sleep(0.05)
        if not path.exists():
            LOGGER.debug("wandb log_model: %s not on disk yet, skipping",
                         path)
            return False
        art = wandb.Artifact(
            f"run_{self.run.id}_model", type="model",
            metadata={"epoch": int(epoch), "fitness": float(fitness),
                      "original_path": str(path)},
        )
        art.add_file(str(path), name=path.name)
        aliases = ["latest", f"epoch {int(epoch) + 1}"]
        if best:
            aliases.append("best")
        self.run.log_artifact(art, aliases=aliases)
        return True

    def download_model_artifact(self, artifact_path: str):
        """`wandb-artifact://...` -> (local checkpoint Path, metadata dict)
        (reference download_model_artifact :284-300)."""
        wandb = _wandb()
        if wandb is None or not is_artifact_path(artifact_path):
            return None, None
        name = remove_prefix(artifact_path)
        if ":" not in name.rsplit("/", 1)[-1]:
            name += ":latest"
        art = self.run.use_artifact(name)
        ckpt_dir = Path(art.download())
        files = sorted(ckpt_dir.glob("*.ckpt")) or sorted(ckpt_dir.glob("*"))
        assert files, f"artifact {name} contained no checkpoint files"
        return files[0], dict(art.metadata or {})

    # -- datasets -----------------------------------------------------------
    def log_dataset_artifact(self, list_file, name: str = "dataset",
                             names=(), preview_rows: int = 32) -> bool:
        """Upload a YOLO-txt dataset (image list + labels/ sidecars) as a
        versioned artifact with a preview table (reference
        log_dataset_artifact :326-369 + create_dataset_table :380-420)."""
        wandb = _wandb()
        if wandb is None:
            return False
        list_file = Path(list_file)
        img_paths = [ln.strip() for ln in list_file.read_text().splitlines()
                     if ln.strip()]
        art = wandb.Artifact(name, type="dataset",
                             metadata={"count": len(img_paths)})
        art.add_file(str(list_file), name=list_file.name)
        table = wandb.Table(columns=["id", "image", "labels"])
        for i, p in enumerate(img_paths):
            p = Path(p)
            art.add_file(str(p), name=f"images/{p.name}")
            lab = Path(str(p.parent).replace("images", "labels")) / (
                p.stem + ".txt")
            rows = ""
            if lab.exists():
                art.add_file(str(lab), name=f"labels/{lab.name}")
                rows = lab.read_text()
            if i < preview_rows:
                table.add_data(p.stem, wandb.Image(str(p)), rows)
        art.add(table, "preview")
        self.run.log_artifact(art)
        return True
