"""Task runner — the concrete-tasks (cargo xtask) analog.

Usage: python tasks.py {test|test-fast|fixtures|bench|bench-suite|doctest|check|cov}
Reference: concrete-tasks/src/main.rs:57-96.
"""

import subprocess
import sys


def run(cmd):
    print("+", " ".join(cmd), file=sys.stderr)
    return subprocess.call(cmd)


def main():
    cmd = sys.argv[1] if len(sys.argv) > 1 else "test"
    if cmd == "test":
        sys.exit(run([sys.executable, "-m", "pytest", "tests/", "-x", "-q"]))
    if cmd == "test-fast":
        sys.exit(run([sys.executable, "-m", "pytest", "tests/", "-x", "-q",
                      "-k", "not fixtures and not slow and not fuzz"]))
    if cmd == "fixtures":
        # conformance fixtures are a host-CPU suite (like concrete-core-test):
        # pin JAX to the CPU before it initializes (cf. tests/conftest).
        # The full run writes its attestation report to docs/fixtures_report.txt
        # (every fixture x parameter entry, pass/fail, measured detail) so the
        # 10-rep grid is a committed artifact, not a claim.
        sys.exit(run([sys.executable, "-c",
                      "import os; os.environ['JAX_PLATFORMS'] = 'cpu';"
                      "import jax; jax.config.update('jax_platforms', 'cpu');"
                      "import datetime, platform, sys;"
                      "from concrete_tpu import fixtures;"
                      "rs = fixtures.run_all();"
                      "lines = [str(r) for r in rs];"
                      "[print(ln) for ln in lines];"
                      "hdr = ['# Conformance fixture attestation',"
                      " '# generated by: python tasks.py fixtures',"
                      " f'# date: {datetime.date.today()}',"
                      " f'# host: {platform.machine()} cpu-backend',"
                      " f'# entries: {len(rs)}, failures:"
                      " {sum(not r.passed for r in rs)}',"
                      " f'# protocol: REPETITIONS=10 SAMPLE_SIZE=100"
                      " (concrete-core-test/src/lib.rs:10-13)', ''];"
                      "open('docs/fixtures_report.txt', 'w')"
                      ".write(chr(10).join(hdr + lines) + chr(10));"
                      "sys.exit(any(not r.passed for r in rs))"]))
    if cmd == "bench":
        sys.exit(run([sys.executable, "bench.py"]))
    if cmd == "bench-suite":
        sys.exit(run([sys.executable, "benchmarks/suite.py"]))
    if cmd == "doctest":
        sys.exit(run([sys.executable, "-m", "pytest", "tests/test_doctests.py", "-q"]))
    if cmd == "check":
        sys.exit(run([sys.executable, "-m", "compileall", "-q", "concrete_tpu"]))
    if cmd == "cov":
        try:
            import pytest_cov  # noqa: F401 — availability probe only
        except ImportError:
            print("pytest-cov is not installed in this environment; "
                  "run `python tasks.py test` for the plain suite",
                  file=sys.stderr)
            sys.exit(2)
        sys.exit(run([sys.executable, "-m", "pytest", "tests/", "-q",
                      "--cov=concrete_tpu", "--cov-report=term"]))
    print(f"unknown task {cmd}", file=sys.stderr)
    sys.exit(2)


if __name__ == "__main__":
    main()
