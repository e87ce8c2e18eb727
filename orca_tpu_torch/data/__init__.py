"""Host-side data: genome sequence stores and contact-matrix targets."""
