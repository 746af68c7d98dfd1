"""Streaming video + audio + text -> sentiment inference.

Counterpart of ``multimodal_transformer_robustness_tpu/cli/realtime.py``
(the reference's ``real-time.py``).  Feature extraction is pluggable
(``--features synthetic`` makes dummy features to drive the serving path;
``--features precomputed`` loads ``.npy`` features).  Sequence lengths pad up
to power-of-two buckets, as on the JAX side, and the forward runs on the
``--device`` given, the card by default, through the port's CUDA kernels;
the CPU runs only when asked for (``--device cpu``), and ``cuda`` without a
card raises.

Run: ``python -m multimodal_transformer_robustness_tpu_torch.cli.realtime
--features synthetic --repeat 3 --device cuda``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import _build
from ..config import ModelSpec, full_active_config
from ..masks import build_masks
from ..models.bert import BertConfig
from ..models.mult import init_supernet, supernet_apply

TORCH_FEATURES_TODO = ("--features torch (MTCNN / wav2vec2 extraction) is not ported "
                       "and not queued: it needs facenet_pytorch, torchaudio and their "
                       "pretrained weights, none of which is in the repo (ROADMAP Queue 1 "
                       "item 6)")
BERT_DIR_TODO = ("--bert_dir (pretrained HF BERT weights) is not ported yet: "
                 "ROADMAP Queue 1, 'checkpoint.py'")


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class GreedyCTCDecoder:
    """(reference real-time.py:54-63)"""

    def __init__(self, labels, blank: int = 0):
        self.labels = labels
        self.blank = blank

    def __call__(self, emission: np.ndarray) -> str:
        indices = emission.argmax(axis=-1)
        dedup = [int(i) for i, prev in zip(indices, [None] + list(indices[:-1]))
                 if i != prev]
        return "".join(self.labels[i] for i in dedup if i != self.blank)


def synthetic_extractors(seed: int = 0):
    rng = np.random.default_rng(seed)

    def face_features(video_path: str) -> np.ndarray:
        return rng.standard_normal((1, 24, 512)).astype(np.float32)

    def audio_features(audio_path: str):
        return (rng.standard_normal((1, 40, 768)).astype(np.float32),
                "this is a synthetic transcript".split())

    return face_features, audio_features


def precomputed_extractors(face_npy: str, audio_npy: str, transcript: str):
    def face_features(video_path: str) -> np.ndarray:
        return np.load(face_npy).astype(np.float32)

    def audio_features(audio_path: str):
        return np.load(audio_npy).astype(np.float32), transcript.split()

    return face_features, audio_features


class StreamingPredictor:
    """Owns the parameters and masks on one device; reusable across clips."""

    def __init__(self, model_path=None, bert_dir=None, seed=0,
                 attn_impl: str = "xla", bert_int8: bool = False,
                 spec=None, bert_cfg=None, device="cuda"):
        if spec is not None and attn_impl != "xla":
            raise ValueError("attn_impl is consumed by the default ModelSpec only; "
                             "set spec.attn_impl on the override")
        if bert_dir:
            raise NotImplementedError(BERT_DIR_TODO)
        from ..data.tokenizer import load_tokenizer

        self.device = _build.resolve_device(device)
        # the default is the reference's MOSEI serving configuration
        # (real-time.py:118-131)
        self.spec = spec or ModelSpec(
            modality_set=("t", "a", "v"), orig_dimensions=(768, 768, 512),
            dimension=200, num_heads=8, head_dim=25, layers_single_attn=3,
            layers_cross_attn=4, layers_self_attn=2,
            attn_dropout=(0.1, 0.1, 0.0, 0.0), relu_dropout=0.1,
            res_dropout=0.3, out_dropout=0.1, embed_dropout=0.3,
            attn_mask=True, output_dim=1, attn_impl=attn_impl)
        self.bert_cfg = bert_cfg or BertConfig(num_layers=4)
        gen = torch.Generator().manual_seed(seed)
        # --bert_int8: int8 fc1 / fc2 (kernel K4), float attention (K2), as
        # the JAX CLIs quantize the frozen extractor: from the float32
        # weights, then cast to the spec's compute dtype
        self.params, self.frozen = init_supernet(gen, self.spec, self.bert_cfg,
                                                 device=self.device,
                                                 bert_int8="ffn" if bert_int8 else None)
        if model_path:
            self.params = _load_reference_params(self.spec, model_path, self.device)
        self.masks = build_masks(self.spec, full_active_config(self.spec),
                                 device=self.device)
        self.tokenizer = load_tokenizer(bert_dir)

    def prepare(self, text_tokens, audio_feats: np.ndarray, face_feats: np.ndarray):
        """Host stage: tokenize, bucket and pad.  Returns the [3, 1, L] token
        stack and the padded audio / vision feature arrays."""
        # bucket on the wordpiece count, so no transcript tail is cut
        max_pos = self.bert_cfg.max_position
        enc = self.tokenizer.encode_plus(" ".join(text_tokens), max_length=max_pos)
        n_real = int(sum(enc["attention_mask"]))  # CLS + pieces + SEP
        L = min(_bucket(n_real), max_pos)
        text = np.stack([[enc["input_ids"][:L]], [enc["token_type_ids"][:L]],
                         [enc["attention_mask"][:L]]])  # [3, 1, L]
        ta = _bucket(audio_feats.shape[1])
        tv = _bucket(face_feats.shape[1])
        d_a, d_v = self.spec.orig_dimensions[1], self.spec.orig_dimensions[2]
        audio = np.zeros((1, ta, d_a), np.float32)
        audio[:, : audio_feats.shape[1]] = audio_feats
        vision = np.zeros((1, tv, d_v), np.float32)
        vision[:, : face_feats.shape[1]] = face_feats
        return text, audio, vision

    @torch.inference_mode()
    def forward(self, text: np.ndarray, audio: np.ndarray, vision: np.ndarray) -> float:
        """Device stage: one forward; reading the scalar waits for the card."""
        inputs = [torch.as_tensor(text, device=self.device),
                  torch.as_tensor(audio, device=self.device),
                  torch.as_tensor(vision, device=self.device)]
        out = supernet_apply(self.spec, self.params, self.masks, inputs,
                             frozen=self.frozen, bert_cfg=self.bert_cfg)
        return float(out[0, 0])

    def predict(self, text_tokens, audio_feats: np.ndarray, face_feats: np.ndarray) -> float:
        return self.forward(*self.prepare(text_tokens, audio_feats, face_feats))


def _load_reference_params(spec: ModelSpec, path: str, device) -> dict:
    """``*.pt``: a state dict under the reference's names (tensors only; a
    whole pickled reference module is not unpickled).  The frozen BERT keeps
    its weights."""
    from ..weights import load_reference_state_dict

    if not path.endswith(".pt"):
        raise NotImplementedError("only *.pt state dicts load for now; Orbax "
                                  "checkpoints wait for the checkpoint port "
                                  "(ROADMAP Queue 1, 'checkpoint.py')")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return load_reference_state_dict(spec, sd, device=device)[0]


def main(argv=None):
    p = argparse.ArgumentParser(description="streaming multimodal sentiment")
    p.add_argument("--video_path", type=str, default=None)
    p.add_argument("--audio_path", type=str, default=None)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--bert_dir", type=str, default=None)
    p.add_argument("--features", choices=["torch", "synthetic", "precomputed"],
                   default="synthetic")
    p.add_argument("--face_npy", type=str, default=None)
    p.add_argument("--audio_npy", type=str, default=None)
    p.add_argument("--transcript", type=str, default="")
    p.add_argument("--repeat", type=int, default=1,
                   help="re-run the clip to show warm-path latency")
    p.add_argument("--attn_impl", choices=["xla", "flash"], default="xla")
    p.add_argument("--bert_int8", action="store_true",
                   help="int8 weights for the frozen BERT's FFN (kernel K4)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu; cuda without a card raises")
    args = p.parse_args(argv)

    if args.features == "torch":
        raise NotImplementedError(TORCH_FEATURES_TODO)
    if args.features == "precomputed":
        face_fn, audio_fn = precomputed_extractors(args.face_npy, args.audio_npy,
                                                   args.transcript)
    else:
        face_fn, audio_fn = synthetic_extractors()

    predictor = StreamingPredictor(args.model_path, args.bert_dir,
                                   attn_impl=args.attn_impl,
                                   bert_int8=args.bert_int8, device=args.device)
    for it in range(args.repeat):
        t0 = time.perf_counter()
        face = face_fn(args.video_path)
        t_face = time.perf_counter()
        audio, transcript = audio_fn(args.audio_path)
        t_audio = time.perf_counter()
        sentiment = predictor.predict(transcript, audio, face)
        t_model = time.perf_counter()
        print(f"[{it}] transcript: {' '.join(transcript)}")
        print(f"[{it}] sentiment: {sentiment:+.4f}  "
              f"(face {1000 * (t_face - t0):.1f} ms, "
              f"audio {1000 * (t_audio - t_face):.1f} ms, "
              f"model {1000 * (t_model - t_audio):.1f} ms, {predictor.device})")
    return predictor


if __name__ == "__main__":
    main()
