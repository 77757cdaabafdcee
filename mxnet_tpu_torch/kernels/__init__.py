"""Kernel tier: the dispatch policy (``tier``), the graph-fusion planner
(``graph_fuse``), the hand-written kernels (``bn_act``, ``take``,
``attention``, ``mlp``, ``int8_dequant``; the legacy flash forward is
the op module ``ops/pallas_flash.py``) and their build (``_build``).
Importing builds nothing and touches no device."""
