"""Plain references of the benchmark's datapaths: torch only, nothing of
the program under test."""
