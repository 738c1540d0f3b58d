"""The benchmark's own code: traffic generation, weights from the seed, the
serving and fine-tuning loops, the reduction of a profiler trace, the FLOP
and byte arithmetic with the table of peaks, the plain reference and the
comparisons that decide ``correct``. Nothing here is read from the program
under test except its engines and their public counters and stamps."""
