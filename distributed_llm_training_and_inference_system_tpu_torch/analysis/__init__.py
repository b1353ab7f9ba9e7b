"""Static analysis of the port's own source.

Only the markers the fleet modules import (``annotations.py``) are here;
the lint passes that read them are ROADMAP queue 1 item 9, step 9e.
"""
