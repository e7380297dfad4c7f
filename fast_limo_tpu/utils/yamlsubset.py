"""Reader for the YAML subset the configuration profiles use.

Covers what `configs/*.yaml` and the reference's profile layout need:
nested block mappings, block sequences (``- item``), flow sequences and
flow mappings (``[a, b]``, ``{k: v}``, nested, and spanning several lines),
plain and quoted scalars, and ``#`` comments.  Scalars resolve as YAML 1.1
(PyYAML's ``safe_load``) does: ``1.e+4`` and ``5.0e-2`` are floats,
``true``/``yes``/``on`` are booleans, ``~``/``null`` is None, everything
else stays a string.  Anchors, tags, multi-documents and block scalars
(``|``, ``>``) are not part of the subset and raise ``ValueError``.
"""

from __future__ import annotations

import re

_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                        |[-+]?\.(?:inf|Inf|INF)
                        |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}


def _scalar(tok: str):
    if tok[:1] in ("'", '"'):
        q = tok[0]
        if len(tok) < 2 or tok[-1] != q:
            raise ValueError(f"unterminated quoted scalar: {tok!r}")
        body = tok[1:-1]
        return body.replace("''", "'") if q == "'" else bytes(
            body, "utf-8").decode("unicode_escape")
    if tok[:1] in ("&", "*", "!", "|", ">"):
        raise ValueError(f"unsupported YAML construct: {tok!r}")
    if tok in _NULL:
        return None
    if tok in _TRUE:
        return True
    if tok in _FALSE:
        return False
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        t = tok.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        return float("nan") if t.endswith("nan") else float(t)
    return tok


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _depth(text: str) -> int:
    """Net bracket depth of a flow fragment, ignoring quoted text."""
    d, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch in "[{":
            d += 1
        elif ch in "]}":
            d -= 1
    return d


class _Flow:
    """Recursive-descent parser of one flow node (``[...]``, ``{...}`` or a
    scalar)."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def node(self):
        self._ws()
        ch = self.s[self.i:self.i + 1]
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        return _scalar(self._token(",]}"))

    def _token(self, stops: str) -> str:
        self._ws()
        if self.s[self.i:self.i + 1] in ("'", '"'):
            q = self.s[self.i]
            j = self.s.index(q, self.i + 1)
            tok, self.i = self.s[self.i:j + 1], j + 1
            return tok
        j = self.i
        while j < len(self.s) and self.s[j] not in stops:
            if (":" in stops and self.s[j] == ":"
                    and self.s[j + 1:j + 2] not in (" ", "\n", "")):
                j += 1          # a colon inside a plain scalar
                continue
            j += 1
        tok, self.i = self.s[self.i:j].strip(), j
        return tok

    def _expect(self, ch: str):
        self._ws()
        if self.s[self.i:self.i + 1] != ch:
            raise ValueError(f"expected {ch!r} at {self.s[self.i:]!r}")
        self.i += 1

    def _seq(self):
        self._expect("[")
        out = []
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.node())
            self._ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1

    def _map(self):
        self._expect("{")
        out = {}
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = _scalar(self._token(":,}"))
            self._expect(":")
            out[key] = self.node()
            self._ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1


def _flow(text: str):
    p = _Flow(text)
    v = p.node()
    p._ws()
    if p.i != len(p.s):
        raise ValueError(f"trailing text after flow node: {p.s[p.i:]!r}")
    return v


def _split_key(content: str):
    """``key: value`` → (key, value text); None when not a mapping entry."""
    m = re.match(r"""^("[^"]*"|'[^']*'|[^'"\[\]{},#][^:]*?)\s*:(?:\s+(.*))?$""",
                 content, re.S)
    if m is None:
        return None
    return _scalar(m.group(1)), (m.group(2) or "").strip()


def load(text: str):
    """Parse a YAML-subset document into dicts, lists and scalars."""
    lines = []          # (indent, content) with flow nodes joined
    pending = None
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            raise ValueError("multi-document YAML is not supported")
        line = _strip_comment(raw).rstrip()
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError("tabs are not valid YAML indentation")
        if pending is not None:
            pending[1] += "\n" + line.strip()
            if _depth(pending[1]) <= 0:
                lines.append(tuple(pending))
                pending = None
            continue
        if not line.strip():
            continue
        entry = [len(line) - len(line.lstrip()), line.strip()]
        if _depth(entry[1]) > 0:
            pending = entry
        else:
            lines.append(tuple(entry))
    if pending is not None:
        raise ValueError("unterminated flow collection")
    if not lines:
        return None
    node, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at: {lines[i][1]!r}")
    return node


def _value(lines, i, indent, text, in_seq=False):
    """The value of a ``key:`` or ``-`` entry on line i-1: inline text, or
    the nested block that follows (a mapping's value may be a sequence at
    the key's own indent)."""
    if text:
        return _flow(text), i
    if i < len(lines) and (lines[i][0] > indent or (
            not in_seq and lines[i][0] == indent
            and lines[i][1].startswith("- "))):
        return _block(lines, i, lines[i][0])
    return None, i


def _block(lines, i, indent):
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        out = []
        while (i < len(lines) and lines[i][0] == indent
               and (lines[i][1] == "-" or lines[i][1].startswith("- "))):
            rest = lines[i][1][1:].strip()
            if _split_key(rest) is not None and rest[:1] not in "[{":
                # "- key: v" opens a mapping whose keys align with "key"
                sub_indent = indent + len(lines[i][1]) - len(rest)
                sub = [(sub_indent, rest)]
                j = i + 1
                while j < len(lines) and lines[j][0] > indent:
                    sub.append(lines[j])
                    j += 1
                node, _ = _block(sub, 0, sub_indent)
                out.append(node)
                i = j
            else:
                node, i = _value(lines, i + 1, indent, rest, in_seq=True)
                out.append(node)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, text = kv
        out[key], i = _value(lines, i + 1, indent, text)
    return out, i
