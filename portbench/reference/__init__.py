"""Plain references of the benchmark's cells: torch and numpy only,
nothing of the program under test."""
