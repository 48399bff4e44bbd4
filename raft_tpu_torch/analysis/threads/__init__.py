"""The runtime lock-order tracer (:mod:`.runtime`); the static lock-order
graph it checks against is ``ci/checks/lock_order.json``, written by the
JAX package's analyzer."""
