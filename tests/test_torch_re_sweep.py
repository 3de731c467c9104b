"""The random-effect coordinate of both packages across tasks, regularizers
and row weights (CPU): logistic, Poisson and linear x L2, L1 and elastic net
(OWL-QN for the last two) x unit rows and weighted rows with zeros, every
row with an offset and a residual, through the ``off``, ``scatter`` and
``pallas`` families of each package (the JAX ``pallas`` family in Pallas
interpret mode, the port's through the kernels' plain version).

Per-lane objectives are held at the ``solver`` tolerance of
tests/tolerances.py across all six runs; coefficients on the lanes whose
stop is decided, i.e. every run ended the lane for the same reason. The
``roadmap`` case is the OWL-QN input on which one port slab lane was once
reported at 1.3419 against 1.3313: logistic, ELASTIC_NET(0.3, alpha 0.5),
``make_glmix_data(default_rng(7), num_users=10, rows_per_user_range=(6,
25), d_fixed=5, d_random=5)``, weights U(0.2, 3) with 10% set to zero,
offsets, tol 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_test_utils import make_glmix_data
from photon_ml_tpu.algorithm.random_effect import RandomEffectCoordinate as JRandom
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.data.game import build_random_effect_dataset as j_build
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from tolerances import assert_allclose

FAMILIES = ("off", "scatter", "pallas")
TASKS = ("LOGISTIC_REGRESSION", "POISSON_REGRESSION", "LINEAR_REGRESSION")
REGS = {"L2": JReg.l2(0.3), "L1": JReg.l1(0.3), "EN": JReg.elastic_net(0.3, 0.5)}


def _data(weighted: bool):
    data, _ = make_glmix_data(np.random.default_rng(7), num_users=10,
                              rows_per_user_range=(6, 25), d_fixed=5, d_random=5)
    rng = np.random.default_rng(8)
    n = data.num_rows
    weight = np.ones(n, np.float32)
    if weighted:
        weight = rng.uniform(0.2, 3.0, size=n).astype(np.float32)
        weight[rng.random(n) < 0.1] = 0.0
    offset = rng.normal(scale=0.3, size=n).astype(np.float32)
    data = dataclasses.replace(data, weight=weight, offset=offset)
    resid = rng.normal(scale=0.3, size=n).astype(np.float32)
    return data, resid


def _port_data(jdata):
    return tgame.GameData(
        response=jdata.response, offset=jdata.offset, weight=jdata.weight,
        ids=dict(jdata.ids), id_vocabs=dict(jdata.id_vocabs),
        shards={k: tgame.HostFeatures(f.indptr, f.indices, f.values, f.dim)
                for k, f in jdata.shards.items()},
    )


CASES = [(t, r, w) for t in TASKS for r in REGS for w in (False, True)]


def _case_id(case):
    task, reg, weighted = case
    if (task, reg, weighted) == ("LOGISTIC_REGRESSION", "EN", True):
        return "roadmap"
    return f"{task.split('_')[0].lower()}-{reg}-{'weighted' if weighted else 'unit'}"


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_random_effect_families_agree_across_packages(case):
    task, reg_name, weighted = case
    jdata, resid = _data(weighted)
    cfg = JReConfig("userId", "per_user")
    jds = j_build(jdata, cfg)
    tds = tgame.build_random_effect_dataset(_port_data(jdata),
                                            tgame.RandomEffectDataConfig("userId", "per_user"),
                                            device="cpu")
    jcfg = JConfig(max_iterations=60, tolerance=1e-4)
    reg = REGS[reg_name]
    runs = {}
    for spec in FAMILIES:
        jc = JRandom(jds, JTask(task), JOpt.LBFGS, jcfg, reg, sparse_kernel=spec)
        w, res = jc.update(jnp.asarray(resid), jc.initial_coefficients())
        runs[f"jax-{spec}"] = (np.asarray(w), np.asarray(res.value), np.asarray(res.reason))
        tc = RandomEffectCoordinate(tds, TaskType(task), OptimizerType.LBFGS,
                                    interop.from_jax_numpy(jcfg, "cpu"),
                                    interop.from_jax_numpy(reg, "cpu"), sparse_kernel=spec)
        w, res = tc.update(torch.from_numpy(resid), tc.initial_coefficients())
        runs[f"port-{spec}"] = (w.numpy(), res.value.numpy(), res.reason.numpy())

    ref_w, ref_value, ref_reason = runs["jax-off"]
    decided = np.all([r[2] == ref_reason for r in runs.values()], axis=0)
    assert decided.any(), "no lane stopped for the same reason in every run"
    for name, (w, value, _) in runs.items():
        assert_allclose(value, ref_value, kind="solver", err_msg=f"{name}: per-lane objectives")
        assert_allclose(w[decided], ref_w[decided], kind="solver",
                        err_msg=f"{name}: coefficients of the decided lanes")
