"""``repro_torch.analysis``: the port's lint, the counterpart of
``repro.analysis`` for the rules the port's policies need.

==========  ======================  =============================================
code        rule                    policy
==========  ======================  =============================================
RL003       host-sync-discipline    no implicit device->host syncs in ``@hot_loop``
RL010       kernel-tile-literals    kernel knobs via ``repro_torch.kernels.tuning``
==========  ======================  =============================================

Run ``python -m repro_torch.analysis [paths...]`` (default: the port's
tree; text or ``--format=json``); suppress a finding inline with ``#
reprolint: disable=RL010`` (same line, or a standalone comment directly
above), or file-wide with ``# reprolint: disable-file=RL010``: the JAX
linter's directives, so one comment serves both.  Stdlib only: it imports
neither torch nor numpy.
"""
from repro_torch.analysis.core import (DEFAULT_PATHS, Finding, LintReport,
                                       lint_paths, rule_table)

__all__ = ["Finding", "LintReport", "lint_paths", "rule_table",
           "DEFAULT_PATHS"]
