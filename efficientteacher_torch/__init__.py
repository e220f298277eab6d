"""Efficient Teacher on PyTorch and CUDA (NVIDIA Hopper).

The port of `efficientteacher_tpu` (JAX/Flax/Pallas), which stays beside it
as the reference. Module paths and names mirror the JAX package, so each
module's counterpart is easy to find. This package imports torch, numpy and
the standard library only, never jax or flax.

Ported so far: the eval serving slice — YOLOv5 forward, decode and
multi-label batched NMS, with hand-written CUDA kernels for greedy NMS
(`ops/nms_cuda.py`, `csrc/nms.cu`) and threshold compaction
(`ops/select_cuda.py`, `csrc/select.cu`); the supervised and mean-teacher
train steps (`train/`); and the trainers around them
(`train/trainer.py`, `train/ssod_trainer.py`) with epoch-end validation
(`eval/validator.run`), checkpoints (`utils/checkpoint.py`) and the
config tree (`configs/`); the data path — loaders from disk without cv2
(`data/`, the host core `csrc/loader_core.cpp`), device augmentation
(`ops/augment_device.py`) — and the CLIs (`cli/train.py`, `cli/val.py`).
"""
