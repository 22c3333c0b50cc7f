"""Operators of the port: hashing, carriers, scans and the kernels'
wrappers; the chaining and nested tables (the clarity builds
``build_chaining`` / ``build_nested`` over ``layout.key_group_index``, the
compacted and dense-direct builds, the probes, ``materialize_chaining_join``,
``unnest`` and ``deferred_two_join_strand``); the windowed probe strands;
``filter`` (``apply_predicate``, ``compact``), ``aggregate``
(``hash_aggregate``), ``sort`` (``sort_by_key``, ``sort_rows``,
``radix_partition``, the probe-sort policy) and ``stats``."""
