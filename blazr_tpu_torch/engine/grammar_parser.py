"""GBNF grammar parser.

Copy of ``blazr_tpu/engine/grammar_parser.py``: parses llama.cpp-style
GBNF into a rule AST consumed by the DFA compiler in ``grammar.py`` and the
PDA compiler in ``grammar_pda.py``. ``GrammarParseError`` is a
``ValueError``, so the server answers 400 for a grammar that does not parse.

Grammar of GBNF itself:
    rule       ::= name "::=" alternates
    alternates ::= sequence ("|" sequence)*
    sequence   ::= item*
    item       ::= (literal | char-class | rule-ref | group) repeat?
    group      ::= "(" alternates ")"
    repeat     ::= "*" | "+" | "?" | "{" n ("," m?)? "}"
    literal    ::= '"' ... '"'
    char-class ::= "[" ("^"?) (c | c "-" c)* "]"
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

Node = Union["Literal", "CharClass", "RuleRef", "Seq", "Alt", "Repeat"]


@dataclass
class Literal:
    data: bytes


@dataclass
class CharClass:
    ranges: list[tuple[int, int]]     # inclusive byte ranges
    negated: bool = False

    def matches(self, b: int) -> bool:
        hit = any(lo <= b <= hi for lo, hi in self.ranges)
        return hit != self.negated


@dataclass
class RuleRef:
    name: str


@dataclass
class Seq:
    items: list[Node] = field(default_factory=list)


@dataclass
class Alt:
    options: list[Node] = field(default_factory=list)


@dataclass
class Repeat:
    item: Node
    min: int
    max: Optional[int]                # None = unbounded


class GrammarParseError(ValueError):
    pass


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.pos = 0

    # -- low-level ---------------------------------------------------------
    def _peek(self) -> str:
        return self.src[self.pos] if self.pos < len(self.src) else ""

    def _advance(self) -> str:
        c = self._peek()
        self.pos += 1
        return c

    def _skip_ws(self, newlines: bool = False) -> None:
        while self.pos < len(self.src):
            c = self.src[self.pos]
            if c == "#":                      # comment to EOL
                while self.pos < len(self.src) and self.src[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t\r" or (newlines and c == "\n"):
                self.pos += 1
            elif c == "\\" and self.pos + 1 < len(self.src) and self.src[self.pos + 1] == "\n":
                self.pos += 2                 # line continuation
            else:
                break

    # -- productions -------------------------------------------------------
    def parse(self) -> dict[str, Node]:
        rules: dict[str, Node] = {}
        self._skip_ws(newlines=True)
        while self.pos < len(self.src):
            name = self._parse_name()
            self._skip_ws()
            if self.src[self.pos : self.pos + 3] != "::=":
                raise GrammarParseError(
                    f"expected '::=' after rule name {name!r} at {self.pos}")
            self.pos += 3
            self._skip_ws()
            rules[name] = self._parse_alternates()
            self._skip_ws(newlines=True)
        if not rules:
            raise GrammarParseError("empty grammar")
        if "root" not in rules:
            raise GrammarParseError("grammar must define a 'root' rule")
        return rules

    def _parse_name(self) -> str:
        start = self.pos
        while self._peek() and (self._peek().isalnum() or self._peek() in "-_"):
            self.pos += 1
        if start == self.pos:
            raise GrammarParseError(f"expected rule name at {self.pos}")
        return self.src[start : self.pos]

    def _parse_alternates(self) -> Node:
        options = [self._parse_sequence()]
        self._skip_ws()
        while self._peek() == "|":
            self._advance()
            self._skip_ws()
            options.append(self._parse_sequence())
            self._skip_ws()
        return options[0] if len(options) == 1 else Alt(options)

    def _parse_sequence(self) -> Node:
        items: list[Node] = []
        while True:
            self._skip_ws()
            c = self._peek()
            if c in ("", "|", ")", "\n"):
                break
            items.append(self._parse_item())
        if len(items) == 1:
            return items[0]
        return Seq(items)

    def _parse_item(self) -> Node:
        c = self._peek()
        if c == '"':
            base: Node = self._parse_literal()
        elif c == "[":
            base = self._parse_char_class()
        elif c == "(":
            self._advance()
            base = self._parse_alternates()
            self._skip_ws()
            if self._advance() != ")":
                raise GrammarParseError(f"expected ')' at {self.pos}")
        else:
            base = RuleRef(self._parse_name())

        # repetition suffix
        self._skip_ws()
        c = self._peek()
        if c == "*":
            self._advance()
            return Repeat(base, 0, None)
        if c == "+":
            self._advance()
            return Repeat(base, 1, None)
        if c == "?":
            self._advance()
            return Repeat(base, 0, 1)
        if c == "{":
            self._advance()
            lo = self._parse_int()
            hi: Optional[int] = lo
            self._skip_ws()
            if self._peek() == ",":
                self._advance()
                self._skip_ws()
                hi = self._parse_int() if self._peek().isdigit() else None
            self._skip_ws()
            if self._advance() != "}":
                raise GrammarParseError(f"expected '}}' at {self.pos}")
            return Repeat(base, lo, hi)
        return base

    def _parse_int(self) -> int:
        start = self.pos
        while self._peek().isdigit():
            self.pos += 1
        if start == self.pos:
            raise GrammarParseError(f"expected integer at {self.pos}")
        return int(self.src[start : self.pos])

    def _parse_escape(self) -> int:
        c = self._advance()
        simple = {"n": 10, "r": 13, "t": 9, "\\": 92, '"': 34, "[": 91,
                  "]": 93, "^": 94, "-": 45, "/": 47, "0": 0}
        if c in simple:
            return simple[c]
        if c in ("x", "u", "U"):
            width = {"x": 2, "u": 4, "U": 8}[c]
            code = int(self.src[self.pos : self.pos + width], 16)
            self.pos += width
            return code
        raise GrammarParseError(f"bad escape '\\{c}' at {self.pos}")

    def _parse_literal(self) -> Literal:
        assert self._advance() == '"'
        out = bytearray()
        while True:
            c = self._peek()
            if c == "":
                raise GrammarParseError("unterminated literal")
            if c == '"':
                self._advance()
                break
            if c == "\\":
                self._advance()
                cp = self._parse_escape()
                out += chr(cp).encode("utf-8")
            else:
                out += self._advance().encode("utf-8")
        return Literal(bytes(out))

    def _parse_char_class(self) -> CharClass:
        assert self._advance() == "["
        negated = False
        if self._peek() == "^":
            negated = True
            self._advance()
        ranges: list[tuple[int, int]] = []

        def read_char() -> int:
            c = self._advance()
            if c == "":       # "[a-" at the end: the JAX parser's TypeError (ROADMAP §C)
                raise GrammarParseError("unterminated char class")
            if c == "\\":
                return self._parse_escape()
            return ord(c)

        while True:
            c = self._peek()
            if c == "":
                raise GrammarParseError("unterminated char class")
            if c == "]":
                self._advance()
                break
            lo = read_char()
            if self._peek() == "-" and self.src[self.pos + 1 : self.pos + 2] != "]":
                self._advance()
                hi = read_char()
            else:
                hi = lo
            # Multi-byte codepoints in classes: approximate with UTF-8 lead
            # byte ranges (byte-level DFA).
            for blo, bhi in _codepoint_range_to_byte_ranges(lo, hi):
                ranges.append((blo, bhi))
        return CharClass(ranges, negated)


def _codepoint_range_to_byte_ranges(lo: int, hi: int) -> list[tuple[int, int]]:
    """Byte-level approximation of a codepoint range. ASCII ranges are
    exact; multi-byte ranges admit any continuation byte (conservative
    over-approximation, same trade-off the reference's byte DFA makes)."""
    out = []
    if lo <= 127:
        out.append((lo, min(hi, 127)))
    if hi > 127:
        out.append((0xC2, 0xF4))      # lead bytes
        out.append((0x80, 0xBF))      # continuation bytes
    return out


def parse_gbnf(src: str) -> dict[str, Node]:
    """Parse GBNF source into {rule_name: AST}."""
    return _Parser(src).parse()
