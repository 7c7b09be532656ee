"""step_eqn10_share — whole step (``SparseTiledLBM.run``; ``SimService`` as
``step_eqn10_share.service``): the paper's Eqn-10 bytes of every node update
of the measured window (of occupied slots in a service) over its seconds
and the card's bandwidth peak, in percent.  The same work whatever
implements it, so it bounds a claim about any part of the step."""
from lbmbench.readers import step_eqn10_share as read  # noqa: F401
