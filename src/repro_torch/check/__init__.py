"""repro_torch.check — static sparse-program verifier (port of
``repro/check``).

Proves the fast path before it runs: runs the real serve/train entry
callables once under an ATen-level recorder (and, on the card, captures
them as CUDA graphs, the programs the runtime replays), runs the R1-R7
rule passes over them, and cross-checks static route predictions against
runtime kernel counters (``--differential``).

CLI::

    python -m repro_torch.check [--entry serve|decode|prefill|train]...
                                [--config NAME]... [--strict] [--json PATH]
                                [--ignore RULE[:entry-glob]]...
                                [--differential] [--no-hlo]
                                [--device cuda|cpu]
"""

from __future__ import annotations

from repro_torch.check.diagnostics import Diagnostic, Report, Severity
from repro_torch.check.rules import Rule, all_rules, run_rules

__all__ = ["Diagnostic", "Report", "Severity", "Rule", "all_rules",
           "run_rules", "run_check", "preflight"]


def run_check(entries, *, arch: str = "bert-base-sten", hlo: bool = True,
              differential: bool = False, ignore=(), device="cuda",
              cfg=None, attn: bool = False) -> Report:
    """Build the entry programs on ``device``, run every rule over each,
    and (optionally) the static-vs-runtime differential.  Returns the
    filtered Report.  ``cfg`` / ``attn``: see
    :func:`~repro_torch.check.entries.entry_programs`."""
    from repro_torch.check.entries import entry_programs
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    report = Report()
    seen: set = set()
    for entry in entries:
        for program in entry_programs(entry, arch=arch, hlo=hlo,
                                      device=device, cfg=cfg, attn=attn):
            if program.name in seen:
                continue
            seen.add(program.name)
            report.programs.append(program.name)
            report.extend(run_rules(program))
    if differential:
        from repro_torch.check.differential import differential_check

        diags, _ = differential_check(arch=arch, device=device)
        report.programs.append(f"{arch}/differential")
        report.extend(diags)
    return report.filtered(ignore)


def preflight(entries, *, arch: str = "bert-base-sten", device="cuda") -> int:
    """The ``--check`` hook of launch/serve.py and launch/train.py: a fast
    (uncaptured) pass over the given entries on ``device``, the report to
    stdout, a process exit code (nonzero only on ERROR diagnostics).
    Call it after the tuning table is loaded, so R6 judges the table the
    run uses."""
    report = run_check(entries, arch=arch, hlo=False, device=device)
    rendered = report.render()
    if rendered:
        print(rendered)
    print(report.summary())
    return report.exit_code(strict=False)
