"""Finding, baseline and allowlist model for repro-check.

A ``Finding`` is one violation: checker, rule, location and message.
Its *fingerprint* deliberately excludes the line number so that
unrelated edits above a known finding do not churn the baseline — only
the checker, rule, file, enclosing symbol and normalized detail count.

The baseline file records open findings by fingerprint.  The contract:

  * a finding in the baseline is *known debt* — reported, but does not
    fail the run;
  * a finding not in the baseline fails the run (``--fail-on-new`` is
    the default and only mode);
  * a baseline entry with no matching finding is *stale* and reported
    so fixed debt gets deleted, never accumulated.

Permanent, audited exceptions do not belong here — they get an in-code
``# repro-check: allow(<tag>)`` annotation next to the excused line.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class Finding:
    checker: str        # "lock-order", "evloop-blocking", ...
    rule: str           # "lock-cycle", "blocking-under-lock", ...
    path: str           # repo-relative file
    line: int
    symbol: str         # enclosing function/class qual ("" if module level)
    message: str
    detail: str = ""    # stable discriminator (lock pair, call chain, ...)

    @property
    def fingerprint(self) -> str:
        raw = "|".join((self.checker, self.rule, self.path, self.symbol,
                        self.detail or self.message))
        return hashlib.sha256(raw.encode()).hexdigest()[:16]

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.checker}/{self.rule}] "
                f"{self.message}  ({self.fingerprint})")


class Baseline:
    VERSION = 1

    def __init__(self, entries: dict[str, str] | None = None):
        # fingerprint -> human summary (for reviewable diffs)
        self.entries: dict[str, str] = dict(entries or {})

    @classmethod
    def load(cls, path: str | Path) -> "Baseline":
        path = Path(path)
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        if data.get("version") != cls.VERSION:
            raise ValueError(
                f"unsupported baseline version {data.get('version')!r} "
                f"in {path}")
        return cls(data.get("findings", {}))

    def save(self, path: str | Path) -> None:
        data = {
            "version": self.VERSION,
            "findings": dict(sorted(self.entries.items())),
        }
        Path(path).write_text(json.dumps(data, indent=1) + "\n")

    @classmethod
    def from_findings(cls, findings: list[Finding]) -> "Baseline":
        return cls({f.fingerprint: f"{f.path}: [{f.checker}/{f.rule}] "
                                   f"{f.message}"
                    for f in findings})

    def split(self, findings: list[Finding]
              ) -> tuple[list[Finding], list[Finding], list[str]]:
        """-> (new findings, baselined findings, stale fingerprints)."""
        new, known = [], []
        seen: set[str] = set()
        for f in findings:
            if f.fingerprint in self.entries:
                known.append(f)
                seen.add(f.fingerprint)
            else:
                new.append(f)
        stale = [fp for fp in self.entries if fp not in seen]
        return new, known, stale
