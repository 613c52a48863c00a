"""The benchmark's general machinery: finding a cell's parts by name
(:mod:`.spec`), the seeded inputs (:mod:`.inputs`), the run itself
(:mod:`.harness`), the device trace (:mod:`.trace`), the arithmetic that
turns spans, requests and kernels into metrics (:mod:`.reduce`), the peaks
and operation counts rooflines divide by (:mod:`.peaks`, :mod:`.counts`)
and the comparison that decides ``correct`` (:mod:`.judge`)."""
