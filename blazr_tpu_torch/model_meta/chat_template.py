"""Chat templates.

Copy of ``blazr_tpu/model_meta/chat_template.py`` (the port imports nothing
of the JAX package), itself a port of the reference chat_template.rs: 8 template
formats (Llama3, MistralInstruct, ChatML, Phi3, Gemma, DeepSeek, Jinja
passthrough→ChatML fallback, Generic), detection from
tokenizer_config.json chat_template patterns or model_type, per-request
override by name, and prompt-injection sanitization (template delimiter
tokens stripped from user/assistant content; system content is trusted —
chat_template.rs:138-166).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass
class ChatMessage:
    role: str                       # system | user | assistant | tool
    content: str


class TemplateFormat(enum.Enum):
    LLAMA3 = "llama3"
    MISTRAL_INSTRUCT = "mistral"
    CHATML = "chatml"
    PHI3 = "phi3"
    GEMMA = "gemma"
    DEEPSEEK = "deepseek"
    GENERIC = "generic"

    @classmethod
    def from_name(cls, name: str) -> "TemplateFormat":
        name = name.lower()
        for fmt in cls:
            if fmt.value == name:
                return fmt
        aliases = {"llama": cls.LLAMA3, "llama-3": cls.LLAMA3,
                   "mistral-instruct": cls.MISTRAL_INSTRUCT,
                   "qwen": cls.CHATML, "qwen2": cls.CHATML, "qwen3": cls.CHATML,
                   "im": cls.CHATML, "gemma2": cls.GEMMA}
        if name in aliases:
            return aliases[name]
        raise ValueError(f"unknown chat template {name!r}")


# Delimiter substrings stripped from UNTRUSTED content per template family
# (prompt-injection sanitization, reference chat_template.rs:138-166).
_SANITIZE_PATTERNS = [
    "<|begin_of_text|>", "<|start_header_id|>", "<|end_header_id|>",
    "<|eot_id|>", "<|im_start|>", "<|im_end|>", "[INST]", "[/INST]",
    "<|system|>", "<|user|>", "<|assistant|>", "<|end|>",
    "<start_of_turn>", "<end_of_turn>",
    "<｜User｜>", "<｜Assistant｜>", "<｜begin▁of▁sentence｜>",
    "<｜end▁of▁sentence｜>", "</s>", "<s>",
]


def sanitize_content(content: str) -> str:
    for pat in _SANITIZE_PATTERNS:
        content = content.replace(pat, "")
    return content


@dataclass
class ChatTemplate:
    format: TemplateFormat = TemplateFormat.GENERIC

    # ---- detection -------------------------------------------------------
    @classmethod
    def detect(cls, model_dir: Optional[str | Path] = None,
               model_type: Optional[str] = None,
               chat_template_str: Optional[str] = None) -> "ChatTemplate":
        """Detect the format from tokenizer_config.json chat_template string
        patterns (chat_template.rs:54-79) or model_type (:82-95)."""
        if chat_template_str is None and model_dir is not None:
            cfg_path = Path(model_dir) / "tokenizer_config.json"
            if cfg_path.exists():
                try:
                    cfg = json.loads(cfg_path.read_text())
                    tmpl = cfg.get("chat_template")
                    if isinstance(tmpl, list):   # named templates
                        tmpl = next((t.get("template") for t in tmpl
                                     if isinstance(t, dict)), None)
                    chat_template_str = tmpl
                except (json.JSONDecodeError, OSError):
                    pass
        if chat_template_str:
            s = chat_template_str
            if "<|start_header_id|>" in s or "<|eot_id|>" in s:
                return cls(TemplateFormat.LLAMA3)
            if "<|im_start|>" in s:
                return cls(TemplateFormat.CHATML)
            if "[INST]" in s:
                return cls(TemplateFormat.MISTRAL_INSTRUCT)
            if "<|user|>" in s and "<|end|>" in s:
                return cls(TemplateFormat.PHI3)
            if "start_of_turn" in s:
                return cls(TemplateFormat.GEMMA)
            if "User｜" in s or "deepseek" in s.lower():
                return cls(TemplateFormat.DEEPSEEK)
            # unknown Jinja → ChatML fallback (chat_template.rs:121-124)
            return cls(TemplateFormat.CHATML)
        if model_type:
            mt = model_type.lower()
            mapping = {
                "llama": TemplateFormat.LLAMA3,
                "mistral": TemplateFormat.MISTRAL_INSTRUCT,
                "qwen2": TemplateFormat.CHATML,
                "qwen3": TemplateFormat.CHATML,
                "phi3": TemplateFormat.PHI3,
                "gemma": TemplateFormat.GEMMA,
                "gemma2": TemplateFormat.GEMMA,
                "deepseek": TemplateFormat.DEEPSEEK,
            }
            if mt in mapping:
                return cls(mapping[mt])
        return cls(TemplateFormat.GENERIC)

    # ---- application -----------------------------------------------------
    def apply(self, messages: list[ChatMessage], add_generation_prompt: bool = True,
              sanitize: bool = True) -> str:
        msgs = []
        for m in messages:
            content = m.content
            if sanitize and m.role != "system":
                content = sanitize_content(content)
            msgs.append(ChatMessage(m.role, content))
        fn = {
            TemplateFormat.LLAMA3: self._llama3,
            TemplateFormat.MISTRAL_INSTRUCT: self._mistral,
            TemplateFormat.CHATML: self._chatml,
            TemplateFormat.PHI3: self._phi3,
            TemplateFormat.GEMMA: self._gemma,
            TemplateFormat.DEEPSEEK: self._deepseek,
            TemplateFormat.GENERIC: self._generic,
        }[self.format]
        return fn(msgs, add_generation_prompt)

    @staticmethod
    def _llama3(msgs: list[ChatMessage], gen: bool) -> str:
        out = "<|begin_of_text|>"
        for m in msgs:
            out += (f"<|start_header_id|>{m.role}<|end_header_id|>\n\n"
                    f"{m.content}<|eot_id|>")
        if gen:
            out += "<|start_header_id|>assistant<|end_header_id|>\n\n"
        return out

    @staticmethod
    def _mistral(msgs: list[ChatMessage], gen: bool) -> str:
        # System folds into the first user turn (Mistral convention).
        out = "<s>"
        system = ""
        for m in msgs:
            if m.role == "system":
                system = m.content
                continue
            if m.role == "user":
                content = f"{system}\n\n{m.content}" if system else m.content
                system = ""
                out += f"[INST] {content} [/INST]"
            elif m.role == "assistant":
                out += f" {m.content}</s>"
        return out

    @staticmethod
    def _chatml(msgs: list[ChatMessage], gen: bool) -> str:
        out = ""
        for m in msgs:
            out += f"<|im_start|>{m.role}\n{m.content}<|im_end|>\n"
        if gen:
            out += "<|im_start|>assistant\n"
        return out

    @staticmethod
    def _phi3(msgs: list[ChatMessage], gen: bool) -> str:
        out = ""
        for m in msgs:
            out += f"<|{m.role}|>\n{m.content}<|end|>\n"
        if gen:
            out += "<|assistant|>\n"
        return out

    @staticmethod
    def _gemma(msgs: list[ChatMessage], gen: bool) -> str:
        out = "<bos>"
        system = ""
        for m in msgs:
            if m.role == "system":
                system = m.content
                continue
            role = "model" if m.role == "assistant" else "user"
            content = m.content
            if system and role == "user":
                content = f"{system}\n\n{content}"
                system = ""
            out += f"<start_of_turn>{role}\n{content}<end_of_turn>\n"
        if gen:
            out += "<start_of_turn>model\n"
        return out

    @staticmethod
    def _deepseek(msgs: list[ChatMessage], gen: bool) -> str:
        out = "<｜begin▁of▁sentence｜>"
        for m in msgs:
            if m.role == "system":
                out += m.content
            elif m.role == "user":
                out += f"<｜User｜>{m.content}"
            elif m.role == "assistant":
                out += f"<｜Assistant｜>{m.content}<｜end▁of▁sentence｜>"
        if gen:
            out += "<｜Assistant｜>"
        return out

    @staticmethod
    def _generic(msgs: list[ChatMessage], gen: bool) -> str:
        out = ""
        for m in msgs:
            out += f"{m.role.capitalize()}: {m.content}\n\n"
        if gen:
            out += "Assistant: "
        return out
