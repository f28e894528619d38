"""The LM architecture configs, as data (a copy of ``repro/configs/lm``).

The twin workload never imports these.  Reach them through the registry
(``repro_torch.configs.get_config`` / ``get_smoke``); the serving path of
:mod:`repro_torch.train.lm_trainer` runs the GQA and Jamba ones.
"""
