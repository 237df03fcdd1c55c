"""Multimodal generation: image embeddings merged with the text's.

Counterpart of ``blazr_tpu/engine/executor_multimodal.py``: images are
preprocessed (``utils/preprocess.py``) and encoded by the vision tower
(``models/vision.py``), their rows prepended to the prompt's token
embeddings (then audio, were there an encoder; JAX :92-98), and the
merged rows prefilled through ``forward_layers_range`` and
``forward_head`` into a cache the ``Executor`` hands out. Decoding is then
the Executor's own (``Executor.generate_embedded``): its decode step (a
CUDA graph on the card) and its sampling, so a request's temperature,
top-p, penalties, grammar and stop strings apply. The JAX executor decodes
by ``argmax`` whatever the request asks (:107, :128); greedy rows with no
penalty are its tokens exactly (ROADMAP §C). Audio without an audio
encoder raises instead of being dropped (the JAX :67-68 drops it), and
no model of the port has one.

Under a mesh (JAX :46-52) the text Executor is the rank's sharded one and
the tower runs whole on every rank: ``vision_params`` are not sliced, every
rank encodes the same images, and the merged rows enter the rank's decoder
layers, whose collectives the ranks run in step (``serve --tp`` drives an
image chat as a lockstep op, ``distributed/lockstep.py``).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..config.generation import GenerationConfig
from ..models.llama import embed_rows
from ..models.vision import encode_images
from ..utils.preprocess import MultimodalError, compute_mel_spectrogram, preprocess_image
from .types import GeneratedToken


class MediaBoundExecutor:
    """Decoded media bound to a MultimodalExecutor, so the text helpers
    (``collect_generation`` / ``stream_generation``) drive a multimodal
    generation unchanged (JAX :23-43)."""

    def __init__(self, mm: "MultimodalExecutor", images, audio):
        self.mm = mm
        self.images = images
        self.audio = audio
        self.executor = mm.executor

    def __getattr__(self, name):
        return getattr(self.executor, name)

    @property
    def rows(self) -> int:
        """The context rows the images add (CLS dropped)."""
        cfg = self.mm.vision_cfg
        return len(self.images) * (cfg.image_size // cfg.patch_size) ** 2

    def generate(self, prompt_ids, gen_cfg=None):
        return self.mm.generate_multimodal(prompt_ids, images=self.images,
                                           audio=self.audio, gen_cfg=gen_cfg)


class MultimodalExecutor:
    """A text Executor with the model's vision tower (and an audio encoder,
    where one is given: none of the port's models has one)."""

    def __init__(self, executor, vision_params=None, vision_cfg=None,
                 audio_encoder=None):
        self.executor = executor
        self.vision_params = vision_params
        self.vision_cfg = vision_cfg
        self.audio_encoder = audio_encoder

    # ------------------------------------------------------------------
    @torch.no_grad()
    def embed_images(self, images: list[bytes]) -> Optional[torch.Tensor]:
        """[N * patches, proj_dim] f32 image rows on the model's device."""
        if not images:
            return None
        if self.vision_params is None:
            raise MultimodalError("model does not support image input")
        pixels = np.stack([preprocess_image(img, self.vision_cfg.image_size)
                           for img in images])
        emb = encode_images(self.vision_params, self.vision_cfg,
                            torch.from_numpy(pixels).to(self.executor.device))
        return emb.reshape(-1, emb.shape[-1])

    def embed_audio(self, audio: list[np.ndarray]) -> Optional[torch.Tensor]:
        if not audio:
            return None
        if self.audio_encoder is None:
            raise MultimodalError("model does not support audio input (no audio encoder)")
        return self.audio_encoder([compute_mel_spectrogram(a) for a in audio])

    @torch.no_grad()
    def merged_embeddings(self, prompt_ids: list[int], images: Optional[list[bytes]] = None,
                          audio: Optional[list[np.ndarray]] = None) -> torch.Tensor:
        """[1, T_total, H] in the model's dtype: image rows, then the
        prompt's token embeddings (the raw table rows, as JAX takes them;
        looked up over the tp ranks' vocab slices under a mesh), then audio
        rows."""
        model = self.executor.model
        aud = self.embed_audio(audio or [])        # refused before any image compute
        img = self.embed_images(images or [])
        text = embed_rows(model.params, torch.tensor(prompt_ids, dtype=torch.long,
                                                     device=model.params["embed"].device))
        parts = [p.to(text.dtype) for p in (img, text, aud) if p is not None]
        return torch.cat(parts, dim=0)[None]

    def generate_multimodal(self, prompt_ids: list[int],
                            images: Optional[list[bytes]] = None,
                            audio: Optional[list[np.ndarray]] = None,
                            gen_cfg: Optional[GenerationConfig] = None
                            ) -> Iterator[GeneratedToken]:
        """Tokens after a prefill from the merged embeddings; the context
        (image rows included) counts against the Executor's capacity. Audio
        without an encoder raises here; the images are decoded, encoded and
        prefilled when the first token is asked for, so a clock started
        before then counts them."""
        if audio and self.audio_encoder is None:
            raise MultimodalError("model does not support audio input (no audio encoder)")
        return self._generate(prompt_ids, images, audio, gen_cfg)

    def _generate(self, prompt_ids, images, audio, gen_cfg) -> Iterator[GeneratedToken]:
        hidden = self.merged_embeddings(prompt_ids, images, audio)
        yield from self.executor.generate_embedded(prompt_ids, hidden, gen_cfg)
