"""One driver per traffic kind: `measure(run)`, `check(run)`, `control(run)`."""
