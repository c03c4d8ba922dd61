"""The NaN trap's hook, inert: the reference checks no stage."""


def check_nans(stage, *outputs) -> None:
    """Does nothing (the program's trap is off unless asked for)."""
