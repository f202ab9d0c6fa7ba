"""The benchmark's harness: the cell's specification by name
(:mod:`harness.spec`), its inputs from the seed (:mod:`harness.scene`), the
timed drive of the program (:mod:`harness.drive`), the device trace
(:mod:`harness.trace`) and the comparison that decides ``correct``
(:mod:`harness.judge`)."""
