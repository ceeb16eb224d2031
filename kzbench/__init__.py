"""The benchmark of kazen_tpu_torch on one H100: ``python3 -m kzbench.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``.

Everything it measures is found by name: a cell in ``cells/<cell>.json``
names its configuration (``configs/<config>.json``, built by
``scenes/<scene>.py``) and its traffic (``traffic/<traffic>.json``, run by
``entries/<entry>.py``); each per-layer metric is a reader of its own in
``metrics/<metric>.py``. ``reference/`` holds the plain reference the
outputs are held against; nothing here imports jax or kazen_tpu.
"""
