"""config-wiring pass: every config field has a CLI flag + doc mention.

The port's copy of the JAX package's pass, over the port's
``config/schema.py`` and its argparse command modules. A
``ServeConfig``/``FleetConfig`` field that can only be set from a TOML
file silently ossifies at its default in every ``serve start``
deployment. The contract:

- every dataclass field of ``ServeConfig`` and ``FleetConfig``
  (config/schema.py) matches at least one ``--flag`` string literal in
  ``cli/commands/{serve,fleet,bench}.py`` (argparse's ``add_argument``
  literals here, click's option literals in JAX: both are string
  constants that start with ``--``);
- every field name is mentioned in ``docs/USER_GUIDE.md`` (verbatim
  snake_case or its dashed flag form); the guide is the repository's,
  shared by the two packages.

Flag matching is word-subsequence with prefix words: the flag's
dash-words (after stripping ``--`` and the ``fleet-``/``serve-``/
``worker-``/``no-`` prefixes; both stripped and unstripped forms are
tried) must appear in order within the field's underscore-words, each
flag word equal to or a prefix of the matched field word. So
``--spec-tokens`` matches ``speculative_tokens`` and ``--kv-hbm-gb``
matches ``kv_hbm_budget_gb``.

Deliberately flag-less fields carry an inline
``# graftlint: ignore[config-wiring]`` on their schema line, or live in
the baseline with a note. The port's baseline carries every JAX entry
the port inherits, with JAX's note; a flag the JAX CLI has and the port's
lacks is a finding to fix, not to baseline.
"""

from __future__ import annotations

import ast

from .core import Finding, LintContext

RULE = "config-wiring"

CONFIG_CLASSES = ("ServeConfig", "FleetConfig")
CLI_FILES = ("cli/commands/serve.py", "cli/commands/fleet.py",
             "cli/commands/bench.py")
_STRIP_PREFIXES = ("fleet-", "serve-", "worker-", "no-")


def _dataclass_fields(mod, cls_name) -> list[tuple[str, int]]:
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            out = []
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name):
                    out.append((stmt.target.id, stmt.lineno))
            return out
    return []


def _normalized_flag_forms(flag: str) -> set[str]:
    """All reasonable normalizations of one ``--flag`` literal."""
    base = flag.lstrip("-")
    forms = {base}
    changed = True
    while changed:
        changed = False
        for form in list(forms):
            for p in _STRIP_PREFIXES:
                if form.startswith(p) and len(form) > len(p):
                    stripped = form[len(p):]
                    if stripped not in forms:
                        forms.add(stripped)
                        changed = True
    return forms


def _cli_flag_words(ctx: LintContext) -> list[tuple[str, ...]]:
    """Every CLI flag literal in the command files, as normalized word
    tuples (``--kv-hbm-gb`` -> ("kv","hbm","gb") and all stripped
    variants)."""
    out: set[tuple[str, ...]] = set()
    for rel in CLI_FILES:
        mod = ctx.module(rel)
        if mod is None:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and node.value.startswith("--") \
                    and len(node.value) > 2:
                # "--a/--no-a" toggle literals split into both forms
                for part in node.value.split("/"):
                    part = part.strip()
                    if not part.startswith("--"):
                        continue
                    for form in _normalized_flag_forms(part):
                        words = tuple(w for w in form.split("-") if w)
                        if words:
                            out.add(words)
    return sorted(out)


def _word_match(flag_word: str, field_word: str) -> bool:
    """One flag word matches one field word when they are equal, one is
    a prefix of the other (``spec``/``speculative``), or they share a
    >= 4-char stem (``cache``/``caching`` — inflected forms diverge
    after the stem, so plain prefixing misses them)."""
    if flag_word == field_word:
        return True
    if field_word.startswith(flag_word) or flag_word.startswith(field_word):
        return min(len(flag_word), len(field_word)) >= 3
    common = 0
    for a, b in zip(flag_word, field_word):
        if a != b:
            break
        common += 1
    return common >= 4


def _matches(flag_words: tuple[str, ...],
             field_words: tuple[str, ...]) -> bool:
    """Flag words must appear in order within the field words (each
    matching per :func:`_word_match`) — and the flag must pin the field
    down reasonably (at least half the field's words, so ``--seed``
    can't claim ``param_seed_whatever``)."""
    i = 0
    matched = 0
    for fw in flag_words:
        while i < len(field_words) and not _word_match(fw, field_words[i]):
            i += 1
        if i >= len(field_words):
            return False
        matched += 1
        i += 1
    return matched * 2 >= len(field_words)


def run(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    schema = ctx.module("config/schema.py")
    if schema is None:
        return [Finding(rule=RULE, file="config/schema.py", line=1,
                        message="config/schema.py not found",
                        key="missing-schema")]
    flags = _cli_flag_words(ctx)
    guide = ctx.read_repo_text("docs/USER_GUIDE.md") or ""
    for cls in CONFIG_CLASSES:
        fields = _dataclass_fields(schema, cls)
        if not fields:
            findings.append(Finding(
                rule=RULE, file=schema.relpath, line=1,
                message=f"dataclass {cls} not found in schema.py",
                key=f"missing-class:{cls}"))
            continue
        for name, lineno in fields:
            words = tuple(w for w in name.split("_") if w)
            if not any(_matches(fw, words) for fw in flags):
                findings.append(Finding(
                    rule=RULE, file=schema.relpath, line=lineno,
                    message=(f"{cls}.{name} has no matching --flag in "
                             f"cli/commands/{{serve,fleet,bench}}.py — "
                             f"field is unreachable from the CLI"),
                    key=f"{cls}.{name}:no-cli-flag"))
            dashed = name.replace("_", "-")
            if guide and name not in guide and dashed not in guide:
                findings.append(Finding(
                    rule=RULE, file=schema.relpath, line=lineno,
                    message=(f"{cls}.{name} is not mentioned in "
                             f"docs/USER_GUIDE.md (neither {name!r} "
                             f"nor {dashed!r})"),
                    key=f"{cls}.{name}:no-doc-mention"))
    return findings
