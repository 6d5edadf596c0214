"""Reusable state-dict key-string helpers, exposed as a public module the way
the reference exposes its ``key_regex`` helper (reference:
v2_depthanything/state_dict_conversion/key_regex.py:41-161; each family tree
there vendors an identical copy — here there is one shared module).

The core convention: a ``#`` character in a prefix pattern stands for "any
run of digits", so ``"blocks.#.attn"`` matches ``"blocks.0.attn"``,
``"blocks.17.attn"``, etc. Improvements over the reference implementation:

* ``replace_prefix`` handles plain prefixes (no ``#``) and ``#`` placeholders
  in the *new* prefix (each ``#`` is filled with the digits captured by the
  corresponding ``#`` of the old prefix, left-to-right) — both of which the
  reference raises on (key_regex.py:68-76).
* ``get_nth_integer`` supports negative indices (count from the right).
"""

from __future__ import annotations

import re

__all__ = [
    "has_prefix",
    "replace_prefix",
    "get_nth_integer",
    "find_match_by_lut",
    "get_suffix_terms",
]


def _hash_pattern(pattern: str) -> re.Pattern:
    """Compile a ``#``-placeholder prefix pattern into an anchored regex:
    every literal character is escaped and each ``#`` becomes ``(\\d+)``."""
    return re.compile("^" + re.escape(pattern).replace(r"\#", r"(\d+)"))


def has_prefix(key: str, prefix: str) -> bool:
    """True when `key` starts with `prefix`, where ``#`` in the prefix
    matches any run of digits: has_prefix("blocks.3.mlp.fc1.weight",
    "blocks.#.mlp") -> True. Equivalent to str.startswith for plain text."""
    return _hash_pattern(prefix).match(key) is not None


def replace_prefix(key: str, old_prefix: str, new_prefix: str) -> str:
    """Swap `old_prefix` (``#`` = any digits) for `new_prefix` at the start of
    `key`; keys that don't match are returned unchanged.

    ``#`` in `new_prefix` is filled with the digits matched by the
    corresponding ``#`` of `old_prefix` in order of appearance:
        replace_prefix("layers.2.blocks.5.norm", "layers.#.blocks.#", "stage#.block#")
        -> "stage2.block5.norm"
    `new_prefix` may not contain more ``#`` than `old_prefix`.
    """
    n_old, n_new = old_prefix.count("#"), new_prefix.count("#")
    if n_new > n_old:
        raise ValueError(
            f"new_prefix has {n_new} '#' placeholders but old_prefix captures only {n_old}"
        )
    m = _hash_pattern(old_prefix).match(key)
    if m is None:
        return key
    filled = new_prefix
    for digits in m.groups():
        if "#" not in filled:
            break
        filled = filled.replace("#", digits, 1)
    return filled + key[m.end():]


def get_nth_integer(key: str, nth: int = 0) -> int:
    """The nth (0-indexed, left-to-right) run of digits in `key`, as an int:
    get_nth_integer("abc.5.xyz.2.aa[0]", 1) -> 2. Negative `nth` counts from
    the right. Raises IndexError when there is no nth integer."""
    digits = re.findall(r"\d+", key)
    try:
        return int(digits[nth])
    except IndexError:
        raise IndexError(f"No {nth}th integer in: {key!r}") from None


def find_match_by_lut(key: str, from_to_lut: dict[str, str]) -> str | None:
    """First LUT value whose key appears as a substring of `key`, else None:
    find_match_by_lut("enc.conv.1.bias", {"conv.1.bias": "offset.1"})
    -> "offset.1". Insertion order of the LUT decides ties."""
    for fragment, replacement in from_to_lut.items():
        if fragment in key:
            return replacement
    return None


def get_suffix_terms(key: str, num_terms: int = 1) -> str:
    """The last `num_terms` period-separated terms of `key`:
    get_suffix_terms("layer.0.fc1.weight", 2) -> "fc1.weight". Negative
    `num_terms` drops that many leading terms instead (reference
    key_regex.py:148-161 semantics)."""
    return ".".join(key.split(".")[-num_terms:])
