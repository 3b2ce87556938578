"""Query planning and execution of aggregate SELECTs."""
