"""DetectBackend: one inference facade over every format the port and the
JAX package emit (counterpart of `efficientteacher_tpu/eval/multi_backend.py`;
reference utils/detect_multi_backend.py:27-355).

The format is detected by suffix; `__call__(uint8 RGB (B, H, W, 3)) ->
decoded (B, N, 5 + nc) float32` is the contract for every one, and
`warmup()` runs it once. Formats:

  .ckpt         port checkpoint (EMA preferred)
  .deploy.ckpt  RepVGG-fused deploy checkpoint (`cli.export --include
                deploy`)
  .pt           reference torch checkpoint (`utils/torch_import.py`)
  .torchscript  traced module (`cli.export --include torchscript`, or the
                reference's), fed NCHW float / norm_scale
  .onnx         ONNX graph (`cli.export --include onnx`, JAX's or the
                reference's) through cv2.dnn, where cv2 imports; without
                cv2 (the port's GPU machine) it raises ImportError
  saved_model/, .pb, .tflite
                the JAX package's TensorFlow exports through tensorflow,
                where it imports (the port writes none of them)

The first four run on the config's device (the CUDA card unless `device
cpu`): the checkpoints in bf16 on the card and float32 on the CPU, as
cli.val; cv2.dnn and tensorflow run on the CPU.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch


class DetectBackend:
    def __init__(self, weights: str, cfg, norm_scale: float = 255.0):
        from ..cli import compute_dtype, resolve_device
        from ..models.spec import spec_from_cfg

        self.weights = str(weights)
        self.norm_scale = norm_scale
        self.spec = dataclasses.replace(spec_from_cfg(cfg),
                                        train_domain=False)
        self.device = resolve_device(cfg.device)
        self.kind = self._detect_kind(self.weights)
        self._infer = None
        self._tf_fn = None
        self._tflite = None
        self._ts = None
        self._dnn = None

        if self.kind in ("ckpt", "deploy", "pt"):
            from ..models.detector import build_model
            from ..utils.torch_import import load_weights_into
            from .validator import InferFn

            spec = dataclasses.replace(self.spec,
                                       deploy=self.kind == "deploy")
            model = build_model(spec, device=self.device)
            load_weights_into(model, self.weights, strict=True)
            self._infer = InferFn(model.eval(), norm_scale,
                                  compute_dtype(self.device), {})
        elif self.kind == "saved_model":
            import tensorflow as tf

            self._tf_mod = tf.saved_model.load(self.weights)
            self._tf_fn = self._tf_mod.f
        elif self.kind == "pb":
            import tensorflow as tf

            gd = tf.compat.v1.GraphDef()
            gd.ParseFromString(Path(self.weights).read_bytes())
            wrapped = tf.compat.v1.wrap_function(
                lambda: tf.compat.v1.import_graph_def(gd, name=""), [])
            # input = the graph's placeholder; output = its last tensor
            # (the frozen concrete function's single Identity result).
            ops = wrapped.graph.get_operations()
            inp = next(o for o in ops if o.type == "Placeholder")
            idents = [o for o in ops if o.type == "Identity"]
            out_op = idents[-1] if idents else ops[-1]
            pruned = wrapped.prune(inp.outputs[0], out_op.outputs[0])
            # pruned concrete functions bind TF tensors, not ndarrays
            self._tf_fn = lambda x: pruned(tf.constant(x))
        elif self.kind == "tflite":
            import tensorflow as tf

            self._tflite = tf.lite.Interpreter(model_path=self.weights)
            self._tflite.allocate_tensors()
        elif self.kind == "torchscript":
            self._ts = torch.jit.load(self.weights, map_location=self.device)
            self._ts.eval()
        elif self.kind == "onnx":
            try:
                import cv2
            except ImportError as e:
                raise ImportError(
                    f"{self.weights}: ONNX runs through cv2.dnn, and cv2 is "
                    f"not installed") from e
            self._dnn = cv2.dnn.readNetFromONNX(self.weights)
        else:
            raise NotImplementedError(f"format {self.kind!r}")

    @staticmethod
    def _detect_kind(path: str) -> str:
        p = Path(path)
        if p.is_dir():
            return "saved_model"
        name = p.name
        if name.endswith(".deploy.ckpt"):
            return "deploy"
        if name.endswith(".ckpt"):
            return "ckpt"
        if name.endswith(".pt"):
            return "pt"
        if name.endswith(".pb"):
            return "pb"
        if name.endswith(".tflite"):
            return "tflite"
        if name.endswith(".torchscript"):
            return "torchscript"
        if name.endswith(".onnx"):
            return "onnx"
        return "unknown"

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images: (B, H, W, 3) uint8 RGB -> decoded (B, N, 5+nc) f32."""
        if self._infer is not None:
            x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
            return self._infer.forward(x).float().cpu().numpy()
        if self._tf_fn is not None:
            x = images.astype(np.float32) / self.norm_scale
            y = np.asarray(self._tf_fn(x))
            return self._rescale_tf(y, images)
        if self._tflite is not None:
            inp = self._tflite.get_input_details()[0]
            out = self._tflite.get_output_details()[0]
            x = images.astype(np.float32) / self.norm_scale
            if inp["dtype"] == np.uint8:  # full-integer-quantized model
                scale, zero_point = inp["quantization"]
                x = (x / scale + zero_point).astype(np.uint8)
            self._tflite.set_tensor(inp["index"], x)
            self._tflite.invoke()
            y = self._tflite.get_tensor(out["index"])
            if out["dtype"] == np.uint8:
                scale, zero_point = out["quantization"]
                y = (y.astype(np.float32) - zero_point) * scale
            return self._rescale_tf(y, images)
        if self._ts is not None:
            x = torch.from_numpy(
                images.transpose(0, 3, 1, 2).astype(np.float32)
                / self.norm_scale).to(self.device)
            with torch.no_grad():
                y = self._ts(x)
            if isinstance(y, (list, tuple)):
                y = y[0]
            return y.float().cpu().numpy()
        if self._dnn is not None:
            x = (images.transpose(0, 3, 1, 2).astype(np.float32)
                 / self.norm_scale)
            self._dnn.setInput(x)
            return np.asarray(self._dnn.forward())
        raise RuntimeError("no backend initialized")

    @staticmethod
    def _rescale_tf(y: np.ndarray, images: np.ndarray) -> np.ndarray:
        """TF-family exports (saved_model/pb/tflite) carry normalized
        xywh; re-scale to input pixels exactly as the reference
        (utils/detect_multi_backend.py:312).

        Guard: artifacts exported before the normalized-output contract
        (export.py pre-r5) already emit pixel coords — re-scaling those
        would silently double-scale. Normalized xywh stays ~O(1) for a
        trained model (worst random-init case: wh <= 4*max_anchor/img,
        ~20 at a 64px test input) while pixel coords reach the image
        size, so a max box coord above half the input size means the
        blob is already pixel-scale; pass it through with a warning."""
        h, w = images.shape[1:3]
        y = np.array(y)
        if np.abs(y[..., :4]).max() > 0.5 * max(h, w):
            import logging

            logging.getLogger(__name__).warning(
                "TF-family model output looks pixel-scaled already "
                "(max box coord %.1f); skipping the normalized-xywh "
                "re-scale — re-export with the current export.py",
                float(np.abs(y[..., :4]).max()))
            return y
        y[..., :4] *= [w, h, w, h]
        return y

    def warmup(self, shape=(1, 640, 640, 3)):
        self(np.zeros(shape, np.uint8))
