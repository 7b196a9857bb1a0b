"""Arrow-IPC staging: minute-bucketed writers and the reverse-merged reader."""
