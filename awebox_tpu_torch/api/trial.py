"""Trial: one OCP from options to its NLP functions and bounds.

Counterpart of ``awebox_tpu/api/trial.py::Trial.build``: architecture ->
processed options -> model -> transcription -> bounds. The homotopy solve
(``optimize``) and the post-processing API are not ported; the batched
refinement (``parallel/refine.py``) continues from a solved primal-dual
state instead.
"""
from __future__ import annotations

import time
from typing import Dict

from ..arch import Architecture
from ..model.builder import make_model
from ..ocp.bounds import build_v_bounds
from ..ocp.transcription import build_ocp
from ..options.options import Options


class Trial:
    def __init__(self, options_seed, name: str = 'trial'):
        if isinstance(options_seed, Options):
            self.options_raw = options_seed
        elif isinstance(options_seed, dict):
            self.options_raw = Options(options_seed)
        else:
            raise TypeError('options seed must be an Options or a dict')
        self.name = name
        self.timings: Dict[str, float] = {}

    def build(self):
        t0 = time.time()
        arch_seed = self.options_raw['user_options.system_model.architecture']
        self.arch = Architecture(dict(arch_seed))
        self.options = self.options_raw.build(self.arch)
        self.timings['build_options'] = time.time() - t0
        t1 = time.time()
        self.model = make_model(self.options, self.arch)
        self.timings['build_model'] = time.time() - t1
        t1 = time.time()
        self.ocp = build_ocp(self.model, self.options)
        self.lb_nominal, self.ub_nominal = build_v_bounds(self.ocp)
        self.timings['build_nlp'] = time.time() - t1
        self.timings['build'] = time.time() - t0
        return self

    def optimize(self, *args, **kwargs):
        raise NotImplementedError(
            'Trial.optimize (the homotopy solve) is not ported; refine from a '
            'solved state with awebox_tpu_torch.parallel.refine')
