"""What the tests of training and serving on a ``data x model`` mesh share
(``tests/test_torch_model_axis*.py``): their worlds of 4 spawned gloo
ranks as data 2 x model 2 (``tests/test_torch_ranks.py``'s
``model_axis``, ``model_axis_serve`` and ``model_axis_ssm``), one a
module, and the reference's single-device engine's greedy tokens.
"""

import contextlib
import os
import subprocess
import sys

import numpy as np

from _torch_cpu import REPO, cli_env
from repro.configs import get_config as jax_get_config

N = 4


@contextlib.contextmanager
def ranks_running(check: str, d):
    """``check`` of ``tests/test_torch_ranks.py`` on ``N`` spawned ranks
    over the directory ``d``, running while the block computes its
    yardsticks; raises unless every rank passed."""
    ranks = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "test_torch_ranks.py"),
         check, str(d), str(N)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=cli_env())
    try:
        yield
        log, _ = ranks.communicate(timeout=600)
    finally:
        if ranks.poll() is None:
            ranks.kill()
    assert ranks.returncode == 0, log


def jax_engine_tokens(cfg, params, batch, reqs):
    """The reference's single-device engine's greedy tokens for ``reqs``,
    from the port's ``params`` (the same tree, carried over as arrays)."""
    import jax.numpy as jnp
    from repro.serve import engine as jengine

    def arrays(t):
        return {k: arrays(v) for k, v in t.items()} if isinstance(t, dict) \
            else jnp.asarray(t.numpy())

    jcfg = jax_get_config(cfg.name.split("-swa")[0])
    if cfg.sliding_window is not None:
        jcfg = jcfg.with_sliding_window(cfg.sliding_window)
    eng = jengine.ServeEngine(jcfg, arrays(params), batch_size=batch,
                              max_len=48)
    done = eng.generate([jengine.Request(prompt=r.prompt,
                                         max_new_tokens=r.max_new_tokens)
                         for r in reqs])
    return [np.asarray(r.generated).tolist() for r in done]
