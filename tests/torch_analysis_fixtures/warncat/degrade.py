# SEEDED VIOLATIONS (warn-category): warnings.warn without an explicit
# category — an anonymous UserWarning nobody can filter on.
import warnings
from warnings import warn


def degrade(msg):
    warnings.warn(msg)
    warn(f"also anonymous: {msg}")
