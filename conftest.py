"""Root test configuration: build the JAX package's native library once on
the controller, before any xdist worker starts.

``loco_asr_tpu.native.load()`` builds ``loco_asr_tpu/native/libloco_audio.so``
in place when it is missing or older than its source; workers that built
it at once could load a partial file.  Building it here, where the
controller (no ``workerinput`` on its config) configures the session,
leaves the workers a finished library.  A failed build changes nothing:
it is reported, each worker then tries as before, and the package's numpy
lanes serve.
"""

import sys


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    try:
        from loco_asr_tpu import native
        native.load()
    except Exception as e:      # the run goes on as it would without this hook
        print(f"conftest.py: the JAX package's native library was not built ahead "
              f"of the workers: {e!r}", file=sys.stderr)
