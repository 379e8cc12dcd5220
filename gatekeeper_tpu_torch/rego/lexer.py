# Copied from gatekeeper_tpu/rego/lexer.py for the PyTorch port.
"""Rego lexer.

Replaces the front of OPA's PEG parser (reference:
vendor/github.com/open-policy-agent/opa/ast/parser.go, grammar rego.peg)
for the template subset.  Newlines are emitted as tokens because Rego rule
bodies separate literals by newline as well as `;`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator

from gatekeeper_tpu_torch.errors import Location, ParseError

KEYWORDS = {
    "package", "import", "default", "not", "with", "as", "some",
    "true", "false", "null", "else",
}

# Multi-char operators first (longest match wins).
OPERATORS = [
    ":=", "==", "!=", "<=", ">=",
    "=", "<", ">", "+", "-", "*", "/", "%", "|", "&",
    ",", ";", ".", ":", "[", "]", "{", "}", "(", ")",
]


@dataclasses.dataclass
class Token:
    kind: str          # 'ident' | 'keyword' | 'string' | 'number' | 'op' | 'newline' | 'eof'
    value: str | int | float
    loc: Location

    def __repr__(self) -> str:  # pragma: no cover
        return f"Token({self.kind},{self.value!r}@{self.loc.row}:{self.loc.col})"


def tokenize(src: str, filename: str = "") -> list[Token]:
    return list(_tokens(src, filename))


def _tokens(src: str, filename: str) -> Iterator[Token]:
    i, n = 0, len(src)
    row, col = 1, 1

    def loc() -> Location:
        return Location(row=row, col=col, file=filename)

    while i < n:
        c = src[i]
        if c == "\n":
            yield Token("newline", "\n", loc())
            i += 1
            row += 1
            col = 1
            continue
        if c in " \t\r":
            i += 1
            col += 1
            continue
        if c == "#":
            while i < n and src[i] != "\n":
                i += 1
            continue
        if c == '"':
            start = loc()
            j = i + 1
            while j < n:
                if src[j] == "\\":
                    j += 2
                    continue
                if src[j] == '"':
                    break
                if src[j] == "\n":
                    raise ParseError("unterminated string", start)
                j += 1
            if j >= n:
                raise ParseError("unterminated string", start)
            raw = src[i : j + 1]
            try:
                val = json.loads(raw)
            except json.JSONDecodeError as e:
                raise ParseError(f"invalid string literal {raw!r}: {e}", start)
            yield Token("string", val, start)
            col += j + 1 - i
            i = j + 1
            continue
        if c == "`":
            start = loc()
            j = src.find("`", i + 1)
            if j < 0:
                raise ParseError("unterminated raw string", start)
            val = src[i + 1 : j]
            yield Token("string", val, start)
            nl = val.rfind("\n")
            if nl >= 0:
                row += val.count("\n")
                col = len(val) - nl + 1  # chars after last newline + closing `
            else:
                col += j + 1 - i
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            start = loc()
            j = i
            while j < n and (src[j].isdigit() or src[j] in ".eE" or
                             (src[j] in "+-" and j > i and src[j - 1] in "eE")):
                j += 1
            text = src[i:j]
            try:
                val = int(text)
            except ValueError:
                try:
                    val = float(text)
                except ValueError:
                    raise ParseError(f"invalid number literal {text!r}", start)
            yield Token("number", val, start)
            col += j - i
            i = j
            continue
        if c.isalpha() or c == "_":
            start = loc()
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            kind = "keyword" if word in KEYWORDS else "ident"
            yield Token(kind, word, start)
            col += j - i
            i = j
            continue
        matched = False
        for op in OPERATORS:
            if src.startswith(op, i):
                yield Token("op", op, loc())
                i += len(op)
                col += len(op)
                matched = True
                break
        if not matched:
            raise ParseError(f"unexpected character {c!r}", loc())
    yield Token("eof", "", loc())
