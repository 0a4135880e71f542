"""The port lints clean against its allowlist: the contract of
``tests/test_lint_clean.py`` for ``paddle_tpu_torch/``.

Every finding of the active rules (PTL001–004) is fixed or allowlisted
with a justification in ``paddle_tpu_torch/analysis/allowlist.py``; an
entry that suppresses nothing is stale and fails here. The port's own
step functions (``analysis.capture.REPO_STEPS``) scan clean under the
capture allowlist, and the static capture plan leaves no break
unaccounted. The main path's deliberate host reads are exempted site
by site, by inline pragma, and their count is pinned here: a new read
in those files is a finding.
"""
from collections import Counter

import pytest

import paddle_tpu_torch.analysis as analysis
from paddle_tpu_torch.analysis import allowlist, capture, planner
from paddle_tpu_torch.analysis.diagnostics import Diagnostic
from paddle_tpu_torch.analysis.lint import allowlist_reason, lint as run_lint

# findings (a ``.cpu()`` and a ``.numpy()`` on one line are two) that
# inline pragmas exempt in the files a step runs through
MAIN_PATH_READS = {
    "paddle_tpu_torch/jit/sot.py": 4,          # the guards' fetches
    "paddle_tpu_torch/serving.py": 10,         # one token fetch a step
    "paddle_tpu_torch/serving_cache.py": 4,    # the KV writer's indices
    "paddle_tpu_torch/core/autograd.py": 1,    # the NaN check's fetch
}


@pytest.fixture(scope="module")
def linted():
    return run_lint()


def test_the_port_lints_clean(linted):
    r = linted
    assert not r.parse_errors, r.parse_errors
    assert not r.diagnostics, (
        "new lint findings in paddle_tpu_torch/ (fix them, or allowlist "
        "them with a justification):\n" + "\n".join(
            d.render() for d in r.diagnostics))


def test_lint_scans_the_whole_port(linted):
    assert linted.files_scanned > 130


def test_suppressions_are_justified_and_used(linted):
    used = {(d.rule, why) for d, why in linted.suppressed}
    for rule, pattern, why in allowlist.ALLOWLIST:
        assert rule and pattern, (rule, pattern)
        assert len(why.split()) >= 4, (rule, pattern, why)
        assert (rule, why) in used, f"stale allowlist entry {pattern}"
    scan = capture.scan_repo_steps()
    used = {(d.rule, why) for d, why in scan.suppressed}
    for rule, pattern, why in allowlist.CAPTURE_ALLOWLIST:
        assert len(why.split()) >= 4, (rule, pattern, why)
        assert (rule, why) in used, f"stale capture entry {pattern}"


def test_the_main_paths_host_reads_are_exempted_site_by_site(linted):
    for path in MAIN_PATH_READS:
        new = Diagnostic("PTL001", f"{path}:1",
                         ".item() — implicit device->host sync in "
                         "library code")
        assert allowlist_reason(new, allowlist.ALLOWLIST) is None, path
    got = Counter(d.location.partition(":")[0]
                  for d, why in linted.suppressed
                  if d.rule == "PTL001"
                  and d.location.partition(":")[0] in MAIN_PATH_READS)
    assert dict(got) == MAIN_PATH_READS
    assert all(why == "inline pragma" for d, why in linted.suppressed
               if d.location.partition(":")[0] in MAIN_PATH_READS)


def test_the_port_step_functions_capture_clean():
    r = capture.scan_repo_steps()
    assert not r.diagnostics, "\n".join(d.render() for d in r.diagnostics)
    assert len(r.functions) == len(capture.REPO_STEPS)
    plan = planner.plan_repo_steps()
    assert plan.consistent() and not plan.unaccounted()
    assert not [d for d in plan.diagnostics if d.severity == "error"]


def test_the_self_check_and_the_cli_entry():
    assert analysis.self_check()["ok"]
    from paddle_tpu_torch.analysis.__main__ import main
    assert main([]) == 0
    assert main(["--capture-plan"]) == 0
    assert main(["--rules"]) == 0
