"""Resilience planes of the port: the fault plans and their points
(:mod:`.faults`), the storage and network fault planes (:mod:`.iofaults`,
:mod:`.netfaults`), the divergence and drift guard (:mod:`.divergence`)
and the per-phase deadline watchdog (:mod:`.watchdog`)."""
