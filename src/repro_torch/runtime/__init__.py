"""Runtime planes the serving fleet needs: ``elastic.py`` (the elastic
tester group behind intent's ``scale`` action) and ``heartbeat.py``
(liveness).  Import them by module; the training supervisor and the
straggler policy are not part of the port yet."""
