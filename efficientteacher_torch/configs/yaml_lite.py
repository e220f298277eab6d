"""A reader for the subset of YAML that the shipped configs use, giving
what `yaml.safe_load` (PyYAML, YAML 1.1) gives. The card's machine has no
PyYAML.

Covered: block mappings and block sequences by indentation, comments,
flow sequences and flow mappings (nested, and spanning lines), single-
and double-quoted scalars, and plain scalars typed by PyYAML's YAML 1.1
resolvers: `yes`/`no`/`on`/`off` are booleans, `~` and `null` are None,
`0x1f`, `017` (octal), `0b101` and `1:30` (base 60) are integers, a float
needs a dot (`1e-4` stays a string, `1.0e-4` is a float, and an exponent
needs its sign: `1.0e4` is a string). Not covered, and refused with a
`ValueError`: anchors, aliases, tags, block scalars (`|`, `>`), several
documents, and timestamps.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py, class Resolver)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
                   r"FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+"
    r"|[-+]?0[0-7_]+"
    r"|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")


def _int(v: str) -> int:
    """PyYAML's construct_yaml_int."""
    v = v.replace("_", "")
    sign = 1
    if v[0] == "-":
        sign = -1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        out, base = 0, 1
        for digit in reversed([int(p) for p in v.split(":")]):
            out += digit * base
            base *= 60
        return sign * out
    return sign * int(v)


def _float(v: str) -> float:
    """PyYAML's construct_yaml_float."""
    v = v.replace("_", "").lower()
    sign = 1.0
    if v[0] == "-":
        sign = -1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        out, base = 0.0, 1
        for digit in reversed([float(p) for p in v.split(":")]):
            out += digit * base
            base *= 60
        return sign * out
    return sign * float(v)


def resolve_plain(text: str) -> Any:
    """Type an unquoted scalar as PyYAML's SafeLoader does."""
    if _TIMESTAMP.match(text):
        raise ValueError(f"timestamps are not covered: {text!r}")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text in _TRUE
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}


def _logical_lines(text: str) -> List[Tuple[int, str, int]]:
    """(indent, content without its comment, line number) of each line
    that holds something."""
    out = []
    for no, raw in enumerate(text.splitlines()):
        if raw.startswith("%") or raw.strip() in ("---", "..."):
            raise ValueError(f"line {no + 1}: directives and document "
                             "markers are not covered")
        body = _strip_comment(raw)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            raise ValueError(f"line {no + 1}: tab indentation")
        out.append((len(body) - len(stripped), stripped.rstrip(), no))
    return out


def _strip_comment(line: str) -> str:
    """The line without a trailing comment (a `#` at its start or after
    white space, outside quotes)."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if quote == '"' and ch == "\\":
                i += 2
                continue
            if ch == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


class _Flow:
    """A flow collection or scalar starting at text[pos]."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def value(self, ctx_flow: bool) -> Any:
        self.ws()
        if self.i >= len(self.s):
            return None
        ch = self.s[self.i]
        if ch == "[":
            return self.seq()
        if ch == "{":
            return self.mapping()
        if ch in "'\"":
            return self.quoted()
        return self.plain(ctx_flow)

    def seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.i >= len(self.s):
                raise ValueError("unterminated flow sequence")
            if self.s[self.i] == "]":
                self.i += 1
                return out
            item = self.value(True)
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == ":":
                # a single-pair mapping inside a flow sequence
                self.i += 1
                item = {item: self.value(True)}
                self.ws()
            out.append(item)
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
            elif self.i < len(self.s) and self.s[self.i] != "]":
                raise ValueError(f"expected ',' or ']' at {self.s[self.i:]!r}")

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.ws()
            if self.i >= len(self.s):
                raise ValueError("unterminated flow mapping")
            if self.s[self.i] == "}":
                self.i += 1
                return out
            key = self.value(True)
            self.ws()
            val = None
            if self.i < len(self.s) and self.s[self.i] == ":":
                self.i += 1
                val = self.value(True)
                self.ws()
            out[_hashable(key)] = val
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
            elif self.i < len(self.s) and self.s[self.i] != "}":
                raise ValueError(f"expected ',' or '}}' at {self.s[self.i:]!r}")

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        parts = []
        while True:
            if self.i >= len(self.s):
                raise ValueError("unterminated quoted scalar")
            ch = self.s[self.i]
            if ch == q:
                if q == "'" and self.s[self.i + 1:self.i + 2] == "'":
                    parts.append("'")
                    self.i += 2
                    continue
                self.i += 1
                break
            if q == '"' and ch == "\\":
                esc = self.s[self.i + 1:self.i + 2]
                n = {"x": 2, "u": 4, "U": 8}.get(esc)
                if n:
                    parts.append(chr(int(self.s[self.i + 2:self.i + 2 + n],
                                         16)))
                    self.i += 2 + n
                    continue
                if esc not in _ESCAPES:
                    raise ValueError(f"unknown escape \\{esc}")
                parts.append(_ESCAPES[esc])
                self.i += 2
                continue
            if ch == "\n":
                # line folding: a single break becomes a space
                j = self.i
                while j < len(self.s) and self.s[j] in " \t\n":
                    j += 1
                breaks = self.s[self.i:j].count("\n")
                while parts and parts[-1] in (" ", "\t"):
                    parts.pop()
                parts.append(" " if breaks == 1 else "\n" * (breaks - 1))
                self.i = j
                continue
            parts.append(ch)
            self.i += 1
        return "".join(parts)

    def plain(self, ctx_flow: bool) -> Any:
        start = self.i
        stops = ",[]{}" if ctx_flow else ""
        if self.s[self.i] in "&*!|>%@`":
            raise ValueError(f"not covered: {self.s[self.i:]!r}")
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch in stops:
                break
            if ch == ":" and (self.i + 1 >= len(self.s)
                              or self.s[self.i + 1] in " \n" + stops):
                break
            self.i += 1
        text = " ".join(p.strip() for p in self.s[start:self.i].split("\n"))
        return resolve_plain(text.strip())


def _hashable(key):
    if isinstance(key, list):
        raise ValueError("a sequence as a mapping key is not covered")
    return key


def _scalar_or_flow(text: str) -> Any:
    f = _Flow(text)
    v = f.value(False)
    f.ws()
    if f.i != len(f.s):
        raise ValueError(f"unexpected text after a value: {f.s[f.i:]!r}")
    return v


def _split_key(content: str):
    """`key: rest` -> (key, rest) or None when the line is no mapping
    entry."""
    f = _Flow(content)
    if content[0] in "'\"":
        key = f.quoted()
    elif content[0] in "[{":
        return None
    else:
        key = None
        j = 0
        while j < len(content):
            if content[j] == ":" and (j + 1 == len(content)
                                      or content[j + 1] == " "):
                key = resolve_plain(content[:j].strip())
                f.i = j
                break
            j += 1
        if key is None:
            return None
    f.ws()
    if f.i >= len(content) or content[f.i] != ":":
        return None
    rest = content[f.i + 1:].strip()
    return _hashable(key), rest


def safe_load(text: str) -> Any:
    """`yaml.safe_load(text)` for the covered subset."""
    lines = _logical_lines(text)
    if not lines:
        return None
    pos, value = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"line {lines[pos][2] + 1}: unexpected indentation")
    return value


def _block(lines, pos: int, indent: int):
    """The block node whose lines start at `pos` with `indent`."""
    content = lines[pos][1]
    if content == "-" or content.startswith("- "):
        return _block_seq(lines, pos, indent)
    if _split_key(content) is not None:
        return _block_map(lines, pos, indent)
    # a scalar or flow collection, perhaps over several lines
    end = pos + 1
    while end < len(lines) and lines[end][0] > indent:
        end += 1
    return end, _scalar_or_flow("\n".join(l[1] for l in lines[pos:end]))


def _child(lines, pos: int, parent_indent: int, rest: str, seq_ok: bool):
    """The value of a `key:` or `-` entry: `rest` on its line, continued
    on deeper lines, or the block below it."""
    if rest:
        if rest == "-" or rest.startswith("- "):
            raise ValueError(f"line {lines[pos - 1][2] + 1}: a block "
                             "sequence on the key's line")
        end = pos
        while end < len(lines) and lines[end][0] > parent_indent:
            end += 1
        text = "\n".join([rest] + [l[1] for l in lines[pos:end]])
        return end, _scalar_or_flow(text)
    if pos < len(lines):
        ind, content, _ = lines[pos]
        if ind > parent_indent:
            return _block(lines, pos, ind)
        if seq_ok and ind == parent_indent and (
                content == "-" or content.startswith("- ")):
            return _block_seq(lines, pos, ind)
    return pos, None


def _block_map(lines, pos: int, indent: int):
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        split = _split_key(lines[pos][1])
        if split is None:
            raise ValueError(f"line {lines[pos][2] + 1}: expected 'key: "
                             f"value', got {lines[pos][1]!r}")
        key, rest = split
        pos, out[key] = _child(lines, pos + 1, indent, rest, seq_ok=True)
    if pos < len(lines) and lines[pos][0] > indent:
        raise ValueError(f"line {lines[pos][2] + 1}: unexpected indentation")
    return pos, out


def _block_seq(lines, pos: int, indent: int):
    out = []
    while pos < len(lines) and lines[pos][0] == indent and (
            lines[pos][1] == "-" or lines[pos][1].startswith("- ")):
        ind, content, no = lines[pos]
        rest = content[1:].lstrip(" ")
        if rest and (_split_key(rest) is not None or rest.startswith("- ")):
            # a nested block on the dash's line: re-read it as a line
            # indented to where its text starts
            inner = ind + len(content) - len(rest)
            sub = [(inner, rest, no)]
            end = pos + 1
            while end < len(lines) and lines[end][0] > ind:
                sub.append(lines[end])
                end += 1
            _, item = _block(sub, 0, inner)
            out.append(item)
            pos = end
            continue
        pos, item = _child(lines, pos + 1, indent, rest, seq_ok=False)
        out.append(item)
    return pos, out
