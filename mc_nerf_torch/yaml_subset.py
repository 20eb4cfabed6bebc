"""A reader of the YAML subset that MC-NeRF's ``config.yaml`` files use.

The port reads the reference's config schema without PyYAML.  Supported:
block mappings at any indent, ``#`` comments, plain, single- and
double-quoted scalars, flow lists (``[2, 4]``) and flow maps
(``{cam_param_stage: 1, global_opt_stage: 1}``), nested, each on one
line.  A plain scalar takes the type ``yaml.safe_load`` (YAML 1.1) gives
it: ``true`` / ``True`` / ``yes`` / ``on`` ... are booleans, ``null`` /
``~`` / nothing is None, decimal, octal (``010``), hex and binary
integers, and floats only where the YAML 1.1 pattern says so (``1.0e-4``
is a float, ``1e-4`` and ``1.0e4`` are strings).  Any other construct
(block sequences, multi-line scalars, anchors, aliases, tags, documents,
timestamps, sexagesimal numbers) raises ``ValueError`` naming its line.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# YAML 1.1 forms this reader refuses: sexagesimal numbers, timestamps,
# the merge key and the value key
_REFUSED = re.compile(r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                      r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt \t].*)?|<<|=)$")
_FLOW_END = ",[]{}"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0"}


def _fail(lineno: int, msg: str):
    raise ValueError(f"config yaml line {lineno}: {msg}")


def resolve_plain(text: str, lineno: int = 0) -> Any:
    """A plain scalar's value, typed as YAML 1.1's implicit resolvers type it."""
    if _REFUSED.match(text):
        _fail(lineno, f"unsupported scalar {text!r} (sexagesimal, timestamp, merge or value key)")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    return text


class _Line:
    """One line's characters, scanned left to right."""

    def __init__(self, text: str, lineno: int, pos: int = 0):
        self.s, self.lineno, self.pos = text, lineno, pos

    def peek(self, k: int = 0) -> str:
        i = self.pos + k
        return self.s[i] if i < len(self.s) else ""

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.pos += 1

    def at_end(self) -> bool:
        return self.pos >= len(self.s)

    def fail(self, msg: str):
        _fail(self.lineno, msg)

    def quoted(self) -> str:
        q = self.peek()
        self.pos += 1
        out = []
        while True:
            c = self.peek()
            if c == "":
                self.fail("a quoted scalar must end on its line (multi-line scalars are "
                          "not supported)")
            self.pos += 1
            if c == q:
                if q == "'" and self.peek() == "'":
                    out.append("'")
                    self.pos += 1
                    continue
                return "".join(out)
            if c == "\\" and q == '"':
                e = self.peek()
                self.pos += 1
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                elif e in ("x", "u", "U"):
                    n = {"x": 2, "u": 4, "U": 8}[e]
                    digits = self.s[self.pos:self.pos + n]
                    if len(digits) != n or not all(ch in "0123456789abcdefABCDEF"
                                                   for ch in digits):
                        self.fail(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.pos += n
                else:
                    self.fail(f"unsupported escape \\{e}")
                continue
            out.append(c)

    def plain(self, flow: bool) -> str:
        """A plain scalar up to a ': ', a comment's ' #', the line's end or
        (in flow context) a flow indicator."""
        start = self.pos
        while not self.at_end():
            c, nxt = self.peek(), self.peek(1)
            if c == ":" and (nxt in ("", " ") or (flow and nxt in _FLOW_END)):
                break
            if flow and c in _FLOW_END:
                break
            self.pos += 1
        return self.s[start:self.pos].rstrip(" ")

    def node(self, flow: bool) -> Tuple[Any, bool]:
        """A value: (value, whether it was a plain scalar)."""
        self.skip_spaces()
        c = self.peek()
        if c in ("&", "*", "!", "|", ">", "%", "@", "`"):
            self.fail(f"unsupported construct {c!r} (anchors, aliases, tags, block scalars "
                      "and directives are not supported)")
        if c == "[":
            return self.flow_list(), False
        if c == "{":
            return self.flow_map(), False
        if c in ("'", '"'):
            return self.quoted(), False
        if c == "-" and self.peek(1) in ("", " "):
            self.fail("block sequences are not supported")
        if c == "?" and self.peek(1) in ("", " "):
            self.fail("complex mapping keys are not supported")
        return resolve_plain(self.plain(flow), self.lineno), True

    def flow_list(self) -> list:
        self.pos += 1
        out = []
        while True:
            self.skip_spaces()
            if self.peek() == "]":
                self.pos += 1
                return out
            if self.at_end():
                self.fail("a flow list must close on its line")
            value, _ = self.node(True)
            self.skip_spaces()
            if self.peek() == ":":
                self.fail("mappings inside a flow list are not supported")
            out.append(value)
            self.separator("]")

    def flow_map(self) -> dict:
        self.pos += 1
        out = {}
        while True:
            self.skip_spaces()
            if self.peek() == "}":
                self.pos += 1
                return out
            if self.at_end():
                self.fail("a flow map must close on its line")
            key, _ = self.node(True)
            self.skip_spaces()
            if self.peek() != ":":
                self.fail("a flow map entry needs 'key: value'")
            self.pos += 1
            self.skip_spaces()
            if self.peek() in (",", "}"):
                out[key] = None
            else:
                out[key], _ = self.node(True)
            self.separator("}")

    def separator(self, close: str) -> None:
        self.skip_spaces()
        if self.peek() == ",":
            self.pos += 1
        elif self.peek() != close:
            self.fail(f"expected ',' or {close!r}, found {self.s[self.pos:]!r}")


def _strip_comment(text: str) -> str:
    """``text`` without its comment: a '#' at the start or after a space,
    outside quoted scalars (which start where a scalar can start)."""
    quote, prev, i = "", " ", 0
    while i < len(text):
        c = text[i]
        i += 1
        if quote:
            if c == "\\" and quote == '"':
                i += 1                       # an escaped character
            elif c == quote and quote == "'" and text[i:i + 1] == "'":
                i += 1                       # '' inside a single-quoted scalar
            elif c == quote:
                quote = ""
        elif c == "#" and prev in (" ", "\t"):
            return text[:i - 1].rstrip(" ")
        elif c in ("'", '"') and prev in (" ", ":", "[", "{", ",", "-"):
            quote = c
        prev = c
    return text.rstrip(" ")


def loads(text: str) -> Optional[Any]:
    """Parse ``text`` as ``yaml.safe_load`` would; None for an empty document."""
    # lineno, indent, key, whether the line holds a value, the value
    entries: List[Tuple[int, int, Any, bool, Any]] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw)
        body = line.lstrip(" ")
        if not body:
            continue
        if body.startswith("\t") or "\t" in line[:len(line) - len(body)]:
            _fail(lineno, "tabs are not allowed in indentation")
        if body.startswith(("---", "...")) and body[3:4] in ("", " "):
            _fail(lineno, "document markers are not supported")
        indent = len(line) - len(body)
        scan = _Line(line, lineno, indent)
        key, plain = scan.node(False)
        if isinstance(key, (list, dict)):
            if entries:
                _fail(lineno, "a flow collection is only supported as a value")
            scan.skip_spaces()
            if not scan.at_end():
                scan.fail("text after the flow collection")
            return key
        scan.skip_spaces()
        if scan.peek() != ":":
            if not entries and scan.at_end():
                return key            # a document of one scalar
            scan.fail("expected 'key: value' (multi-line scalars are not supported)")
        scan.pos += 1
        scan.skip_spaces()
        if scan.at_end():
            entries.append((lineno, indent, key, False, None))
            continue
        value, _ = scan.node(False)
        scan.skip_spaces()
        if not scan.at_end():
            scan.fail(f"unexpected text {scan.s[scan.pos:]!r} after the value")
        entries.append((lineno, indent, key, True, value))
    if not entries:
        return None
    out, i = _block(entries, 0, entries[0][1])
    if i != len(entries):
        _fail(entries[i][0], "bad indentation")
    return out


def _block(entries, i: int, indent: int) -> Tuple[dict, int]:
    out = {}
    while i < len(entries):
        lineno, ind, key, has_value, value = entries[i]
        if ind < indent:
            break
        if ind > indent:
            _fail(lineno, "bad indentation")
        i += 1
        nested = i < len(entries) and entries[i][1] > indent
        if has_value and nested:
            _fail(entries[i][0], "bad indentation (a value cannot be followed by a nested "
                                 "mapping)")
        if nested:
            value, i = _block(entries, i, entries[i][1])
        out[key] = value
    return out, i
