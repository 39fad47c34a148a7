"""Glob matching for policy topic patterns and bus subjects.

Policy rules match topics with shell-style globs (``job.*`` matches
``job.default`` but also ``job.a.b`` under fnmatch semantics; the reference
uses Go ``path.Match``-style matching where ``*`` does not cross ``.``).
We implement segment-aware matching: ``*`` matches exactly one dot-delimited
token, ``>`` matches one-or-more trailing tokens (NATS semantics), and a
pattern without wildcards must match exactly.  ``glob_match`` additionally
supports ``*`` inside a token (prefix/suffix globs like ``deploy-*``).
"""
from __future__ import annotations

import fnmatch


def subject_match(pattern: str, subject: str) -> bool:
    """NATS-style subject matching: ``*`` = one token, ``>`` = tail."""
    if pattern == subject:
        return True
    ptoks = pattern.split(".")
    stoks = subject.split(".")
    for i, p in enumerate(ptoks):
        if p == ">":
            return len(stoks) >= i + 1
        if i >= len(stoks):
            return False
        if p != "*" and p != stoks[i]:
            return False
    return len(ptoks) == len(stoks)


def glob_match(pattern: str, value: str) -> bool:
    """Policy-style glob: fnmatch per dot-segment; bare ``*``/``>`` wildcards.

    ``job.*`` matches ``job.echo`` but not ``job.a.b``;
    ``job.>`` matches any deeper subject; ``deploy-*`` matches ``deploy-prod``.
    """
    if pattern == value or pattern in ("*", "**", ">"):
        return True
    ptoks = pattern.split(".")
    vtoks = value.split(".")
    for i, p in enumerate(ptoks):
        if p == ">":
            return len(vtoks) >= i + 1
        if i >= len(vtoks):
            return False
        if not fnmatch.fnmatchcase(vtoks[i], p):
            return False
    return len(ptoks) == len(vtoks)
