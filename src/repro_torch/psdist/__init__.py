"""The paper's consistency models as gradient-synchronization policies."""
