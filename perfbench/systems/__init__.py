"""The system under test, one module per kind of configuration.

A configuration names its kind under ``"system"``; ``perfbench.run`` imports
``perfbench.systems.<kind>`` and calls its ``build(cfg, traffic, inputs,
device)``, which returns the program's object that the traffic's loop
drives.  These modules are the only part of perfbench that imports the
program (``fusion_tpu_torch``).
"""
