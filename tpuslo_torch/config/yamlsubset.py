"""A reader for the subset of YAML the toolkit's configuration files use.

The card's machine has no PyYAML, so the port reads ``toolkit.yaml``
itself.  The subset is what the toolkit writes and ships:

* block mappings and block sequences (a sequence may sit at its key's
  indent, and a sequence item may open a compact mapping: ``- k: v``);
* plain, single-quoted and double-quoted scalars, resolved as YAML 1.1
  resolves them (``safe_load``): null, booleans (``true``, ``yes``,
  ``on`` and their negations), decimal, hexadecimal, octal and binary
  integers, floats (with a dot; ``.inf``, ``.nan``) and strings;
* comments, and ``[]`` / ``{}`` and one-line flow sequences and flow
  mappings (``[a, b]``, ``{k: v, k2: v2}``).

Anything else (anchors, aliases, tags, block scalars, multi-line flow
collections, plain scalars continued over lines, directives and
document markers, tabs in indentation, timestamps and sexagesimal
numbers) raises :class:`ValueError` naming the line: the reader never
returns something other than what ``yaml.safe_load`` would.
"""

from __future__ import annotations

import re
from typing import IO, Any

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_INT_DEC = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_INT_OTHER = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+)$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$"
)
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
# Indicators that open a construct outside the subset.
_UNSUPPORTED_START = {
    "&": "anchor", "*": "alias", "!": "tag", "|": "block scalar",
    ">": "block scalar", "%": "directive", "@": "reserved indicator",
    "`": "reserved indicator", "?": "complex key",
}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ",
            "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _error(lineno: int, what: str) -> ValueError:
    return ValueError(f"line {lineno}: {what} is outside the YAML subset the port reads")


def resolve_plain(text: str, lineno: int) -> Any:
    """A plain scalar's value, as YAML 1.1's implicit resolvers give it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT_DEC.match(text):
        return int(text.replace("_", ""))
    if _INT_OTHER.match(text):
        digits = text.replace("_", "")
        sign = -1 if digits.startswith("-") else 1
        digits = digits.lstrip("+-")
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        return sign * int(digits, 8)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.match(text):
        return float("nan")
    if _SEXAGESIMAL.match(text):
        raise _error(lineno, f"sexagesimal number {text!r}")
    if _TIMESTAMP.match(text):
        raise _error(lineno, f"timestamp {text!r}")
    if text == "<<" or text == "=":
        raise _error(lineno, f"key {text!r}")
    return text


class _Cursor:
    """One line's text read left to right (flow collections and quoted
    scalars never span lines in the subset)."""

    def __init__(self, text: str, lineno: int):
        self.text = text
        self.pos = 0
        self.lineno = lineno

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_spaces(self) -> None:
        while self.peek() in (" ", "\t") and self.peek():
            self.pos += 1

    def rest(self) -> str:
        return self.text[self.pos:]

    def at_end(self) -> bool:
        """Only spaces and a comment are left."""
        self.skip_spaces()
        return not self.peek() or self.peek() == "#"

    def quoted(self) -> str:
        quote = self.peek()
        self.pos += 1
        out = []
        while True:
            ch = self.peek()
            if not ch:
                raise _error(self.lineno, "a quoted scalar continued over lines")
            self.pos += 1
            if quote == "'":
                if ch == "'":
                    if self.peek() == "'":
                        out.append("'")
                        self.pos += 1
                        continue
                    return "".join(out)
                out.append(ch)
                continue
            if ch == '"':
                return "".join(out)
            if ch != "\\":
                out.append(ch)
                continue
            esc = self.peek()
            self.pos += 1
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
            elif esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                digits = self.text[self.pos:self.pos + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise _error(self.lineno, f"escape \\{esc}{digits!r}")
                out.append(chr(int(digits, 16)))
                self.pos += n
            else:
                raise _error(self.lineno, f"escape \\{esc}")

    def flow_plain(self, stops: str) -> str:
        start = self.pos
        while self.peek() and self.peek() not in stops:
            if self.peek() == ":" and self.text[self.pos + 1:self.pos + 2] in (" ", ",", "]",
                                                                               "}", ""):
                break
            if self.peek() == "#" and self.pos > start and self.text[self.pos - 1] == " ":
                raise _error(self.lineno, "a comment inside a flow collection")
            self.pos += 1
        return self.text[start:self.pos].rstrip()

    def flow_node(self, stops: str) -> Any:
        self.skip_spaces()
        ch = self.peek()
        if ch == "[":
            return self.flow_sequence()
        if ch == "{":
            return self.flow_mapping()
        if ch in ("'", '"'):
            return self.quoted()
        if ch in _UNSUPPORTED_START:
            raise _error(self.lineno, _UNSUPPORTED_START[ch])
        return resolve_plain(self.flow_plain(stops), self.lineno)

    def flow_sequence(self) -> list:
        self.pos += 1
        out: list = []
        while True:
            self.skip_spaces()
            if self.peek() == "]":
                self.pos += 1
                return out
            if not self.peek():
                raise _error(self.lineno, "a flow sequence continued over lines")
            item = self.flow_node(",]")
            self.skip_spaces()
            if self.peek() == ":":
                raise _error(self.lineno, "a mapping inside a flow sequence")
            out.append(item)
            self.skip_spaces()
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() != "]":
                raise _error(self.lineno, f"{self.rest()!r} in a flow sequence")

    def flow_mapping(self) -> dict:
        self.pos += 1
        out: dict = {}
        while True:
            self.skip_spaces()
            if self.peek() == "}":
                self.pos += 1
                return out
            if not self.peek():
                raise _error(self.lineno, "a flow mapping continued over lines")
            key = self.flow_node(",:}")
            self.skip_spaces()
            value = None
            if self.peek() == ":":
                self.pos += 1
                self.skip_spaces()
                if self.peek() not in (",", "}"):
                    value = self.flow_node(",}")
            _hashable(key, self.lineno)
            out[key] = value
            self.skip_spaces()
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() != "}":
                raise _error(self.lineno, f"{self.rest()!r} in a flow mapping")


def _hashable(key: Any, lineno: int) -> None:
    if isinstance(key, (list, dict)):
        raise _error(lineno, "a collection used as a key")


def _split_key(content: str, lineno: int) -> tuple[Any, str] | None:
    """``key: rest`` → (key, rest); None when the line holds no key."""
    cur = _Cursor(content, lineno)
    if cur.peek() in ("'", '"'):
        key = cur.quoted()
        cur.skip_spaces()
        if cur.peek() != ":":
            return None
        cur.pos += 1
        if cur.peek() not in (" ", ""):
            raise _error(lineno, f"{content!r}")
        return key, cur.rest()
    if cur.peek() in ("[", "{"):
        return None
    match = re.search(r":(?: |$)", content)
    if match is None:
        return None
    raw = content[:match.start()]
    if " #" in raw:
        return None
    if raw[:1] in _UNSUPPORTED_START:
        raise _error(lineno, _UNSUPPORTED_START[raw[:1]])
    return resolve_plain(raw.rstrip(), lineno), content[match.end():]


def _inline_value(text: str, lineno: int) -> tuple[bool, Any]:
    """The value written on the line itself: (True, value), or (False,
    None) when the line ends after the indicator (a nested block)."""
    cur = _Cursor(text, lineno)
    if cur.at_end():
        return False, None
    ch = cur.peek()
    if ch in _UNSUPPORTED_START:
        raise _error(lineno, _UNSUPPORTED_START[ch])
    if ch in (",", "]", "}"):
        raise _error(lineno, f"a plain scalar opening with {ch!r}")
    if ch in ("'", '"'):
        value = cur.quoted()
    elif ch == "[":
        value = cur.flow_sequence()
    elif ch == "{":
        value = cur.flow_mapping()
    elif text.lstrip().startswith("- ") or text.strip() == "-":
        raise _error(lineno, "a sequence opened on its key's line")
    else:
        plain = re.split(r"\s#", cur.rest(), maxsplit=1)[0].rstrip()
        if re.search(r":(?: |$)", plain):
            raise _error(lineno, "a mapping opened on its key's line")
        return True, resolve_plain(plain, lineno)
    if not cur.at_end():
        raise _error(lineno, f"{cur.rest()!r} after a value")
    return True, value


class _Parser:
    def __init__(self, text: str):
        self.lines: list[tuple[int, int, str]] = []  # (lineno, indent, content)
        for lineno, raw in enumerate(text.splitlines(), start=1):
            stripped = raw.lstrip(" ")
            if not stripped or stripped.startswith("#"):
                continue
            if stripped.startswith("\t"):
                raise _error(lineno, "a tab in indentation")
            if raw.startswith(("---", "...")) and raw[3:4] in ("", " "):
                raise _error(lineno, "a document marker")
            self.lines.append((lineno, len(raw) - len(stripped), stripped.rstrip()))
        self.i = 0

    def parse(self) -> Any:
        if not self.lines:
            return None
        value = self.node(self.lines[0][1])
        if self.i < len(self.lines):
            lineno, _, content = self.lines[self.i]
            raise _error(lineno, f"{content!r} after the document's top node")
        return value

    def node(self, indent: int) -> Any:
        lineno, at, content = self.lines[self.i]
        if at != indent:
            raise _error(lineno, "an unexpected indent")
        if content == "-" or content.startswith("- "):
            return self.sequence(indent)
        if _split_key(content, lineno) is not None:
            return self.mapping(indent)
        # A lone scalar or flow collection as the whole node.
        self.i += 1
        has, value = _inline_value(content, lineno)
        if self.i < len(self.lines) and self.lines[self.i][1] > indent:
            raise _error(self.lines[self.i][0], "a plain scalar continued over lines")
        return value

    def _child(self, indent: int, lineno: int, allow_same_indent_seq: bool) -> Any:
        """The block under a key or item whose line ended after its
        indicator: a deeper node, a sequence at the key's own indent, or
        null."""
        if self.i >= len(self.lines):
            return None
        _, nxt, content = self.lines[self.i]
        if nxt > indent:
            return self.node(nxt)
        if (allow_same_indent_seq and nxt == indent
                and (content == "-" or content.startswith("- "))):
            return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            lineno, at, content = self.lines[self.i]
            if at < indent:
                break
            if at > indent:
                raise _error(lineno, "an unexpected indent")
            if content == "-" or content.startswith("- "):
                break
            split = _split_key(content, lineno)
            if split is None:
                raise _error(lineno, f"{content!r} in a mapping")
            key, rest = split
            _hashable(key, lineno)
            self.i += 1
            has, value = _inline_value(rest, lineno)
            if has:
                if self.i < len(self.lines) and self.lines[self.i][1] > indent:
                    raise _error(self.lines[self.i][0],
                                 "a plain scalar continued over lines")
            else:
                value = self._child(indent, lineno, allow_same_indent_seq=True)
            out[key] = value
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            lineno, at, content = self.lines[self.i]
            if at != indent or not (content == "-" or content.startswith("- ")):
                if at > indent:
                    raise _error(lineno, "an unexpected indent")
                break
            rest = content[1:]
            body = rest.lstrip(" ")
            if not body or body.startswith("#"):
                self.i += 1
                out.append(self._child(indent, lineno, allow_same_indent_seq=False))
                continue
            # The item's content becomes a line of its own at its column,
            # so a compact mapping or a nested sequence parses as a block.
            column = indent + 1 + (len(rest) - len(body))
            self.lines[self.i] = (lineno, column, body)
            out.append(self.node(column))
        return out


def safe_load(stream: str | IO[str]) -> Any:
    """Parse one YAML document of the subset; ``ValueError`` names the
    first line outside it."""
    text = stream if isinstance(stream, str) else stream.read()
    return _Parser(text).parse()
