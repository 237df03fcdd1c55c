"""Named inference slots.

Counterpart of ``blazr_tpu/server/slots.py``, the reference SlotManager
(src/engine/slots.rs:30): named sessions tracking model, token counts and
last access; the KV persistence hook is reserved (slots.rs:6-7).
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field


@dataclass
class Slot:
    slot_id: str
    model: str
    created_at: float = field(default_factory=time.time)
    last_access: float = field(default_factory=time.time)
    prompt_tokens: int = 0
    generated_tokens: int = 0

    def to_dict(self) -> dict:
        return {"id": self.slot_id, "model": self.model, "created_at": self.created_at,
                "last_access": self.last_access, "prompt_tokens": self.prompt_tokens,
                "generated_tokens": self.generated_tokens}


class SlotManager:
    def __init__(self, max_slots: int = 64):
        self.max_slots = max_slots
        self._slots: dict[str, Slot] = {}

    def create(self, model: str) -> dict:
        if len(self._slots) >= self.max_slots:
            # evict the least recently used
            victim = min(self._slots.values(), key=lambda s: s.last_access)
            del self._slots[victim.slot_id]
        sid = uuid.uuid4().hex[:12]
        slot = Slot(slot_id=sid, model=model)
        self._slots[sid] = slot
        return slot.to_dict()

    def touch(self, slot_id: str, prompt_tokens: int = 0, generated_tokens: int = 0) -> None:
        s = self._slots.get(slot_id)
        if s is not None:
            s.last_access = time.time()
            s.prompt_tokens += prompt_tokens
            s.generated_tokens += generated_tokens

    def delete(self, slot_id: str) -> bool:
        return self._slots.pop(slot_id, None) is not None

    def list(self) -> list[dict]:
        return [s.to_dict() for s in self._slots.values()]
