"""The yardstick: peaks, bounds, traffic generation, the reduction of a
profiler trace, and the comparison that decides ``correct``.  Plain code
that imports nothing of the program, so a change to the program cannot
change how it is measured."""
