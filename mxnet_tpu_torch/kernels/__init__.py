"""Kernel tier: the dispatch policy (``tier``), the graph-fusion planner
(``graph_fuse``), the hand-written kernels (``bn_act``, ``take``,
``attention``) and their build (``_build``). Importing builds nothing
and touches no device."""
