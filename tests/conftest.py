import os
import sys

# tests run against src/ without installation
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")


# NOTE: do NOT set --xla_force_host_platform_device_count here — smoke
# tests and benches must see the real single device; only the dry-run
# subprocess uses 512 placeholder devices.

try:
    import hypothesis  # noqa: F401
except ImportError:
    # Minimal deterministic shim covering the subset of the hypothesis API
    # the suite uses (given/settings, strategies.integers/sampled_from),
    # so the tier-1 suite runs on images without the package. Examples are
    # drawn from a fixed-seed PRNG — same coverage every run.
    import functools
    import inspect
    import random
    import types

    class _Strategy:
        def __init__(self, sample):
            self.sample = sample

    def _integers(min_value, max_value):
        return _Strategy(lambda rnd: rnd.randint(min_value, max_value))

    def _sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda rnd: rnd.choice(elements))

    class _settings:
        def __init__(self, max_examples=10, **_):
            self.max_examples = max_examples

        def __call__(self, fn):
            fn._stub_max_examples = self.max_examples
            return fn

    def _given(**strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_stub_max_examples",
                            getattr(fn, "_stub_max_examples", 10))
                rnd = random.Random(0)
                for _ in range(n):
                    drawn = {k: s.sample(rnd) for k, s in strategies.items()}
                    fn(*args, **kwargs, **drawn)

            # hide the strategy params from pytest's fixture resolution
            sig = inspect.signature(fn)
            wrapper.__signature__ = sig.replace(parameters=[
                p for name, p in sig.parameters.items()
                if name not in strategies])
            del wrapper.__wrapped__
            return wrapper
        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.sampled_from = _sampled_from
    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st
