"""Trivial byte-level tokenizer (id == byte value, 0 reserved as EOS).

Copy of ``blazr_tpu/tokenizer/byte_tok.py``: used by synthetic runs and
tests; handy as a debugging tokenizer for models without a real vocab file.
"""

from __future__ import annotations


class ByteTokenizer:
    eos_token_id = 0
    bos_token_id = None

    def encode(self, text: str, **kw) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", "replace")

    def is_eos(self, t: int) -> bool:
        return t == 0

    @property
    def vocab_size(self) -> int:
        return 256

    def vocab_bytes(self) -> list[bytes]:
        out = [bytes([i]) for i in range(256)]
        out[0] = b""
        return out
